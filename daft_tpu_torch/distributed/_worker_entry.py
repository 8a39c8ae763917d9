"""Worker subprocess entry point (counterpart of
daft_tpu/distributed/_worker_entry.py; kept apart from worker.py so that
``python -m`` does not run a module the package already imported).

    python -m daft_tpu_torch.distributed._worker_entry ADDRESS WORKER_ID CONFIG_JSON
"""

import sys

if __name__ == "__main__":
    from daft_tpu_torch.distributed.worker import main

    main(sys.argv[1:])
