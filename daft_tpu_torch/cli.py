"""daft_tpu_torch's console entry point (counterpart of daft_tpu/cli.py).

    python -m daft_tpu_torch info                 # engine, torch and card summary
    python -m daft_tpu_torch sql "SELECT ..." -t t=data/*.parquet [--json]
    python -m daft_tpu_torch schema PATH          # a file's inferred schema

Every subcommand takes ``--device {cuda,cpu}`` (the port's own flag,
"cuda" by default: ``ExecutionConfig.device`` has no environment variable),
where its queries' device stages run; with no card a query fails unless
"cpu" is asked for. The reference's ``bench`` subcommand runs its
``bench.py``; the port's benchmark is not written yet, so ``bench`` exits
non-zero saying so.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_info(_args) -> int:
    import torch

    import daft_tpu_torch
    from .config import execution_config

    print(f"daft_tpu_torch (the PyTorch/CUDA port) at "
          f"{daft_tpu_torch.__path__[0]}")
    cards = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_available() else []
    print(f"torch {torch.__version__} cuda={torch.version.cuda} devices={cards}")
    print(f"execution config: {execution_config()}")
    return 0


def _read(path: str):
    import daft_tpu_torch as dt

    if path.endswith((".parquet", ".pq")) or "*" in path:
        return dt.read_parquet(path)
    if path.endswith((".csv", ".tsv")):
        return dt.read_csv(path)
    return dt.read_json(path)


def _cmd_sql(args) -> int:
    import daft_tpu_torch as dt

    tables = {}
    for spec in args.table or []:
        name, path = spec.split("=", 1)
        tables[name] = _read(path)
    df = dt.sql(args.query, **tables)
    out = df.limit(args.limit).to_pydict() if args.limit else df.to_pydict()
    if args.json:
        print(json.dumps(out, default=str))
    else:
        cols = list(out)
        n = len(out[cols[0]]) if cols else 0
        print(" | ".join(cols))
        for i in range(n):
            print(" | ".join(str(out[c][i]) for c in cols))
    return 0


def _cmd_schema(args) -> int:
    for f in _read(args.path).schema:
        print(f"{f.name}: {f.dtype}")
    return 0


def _cmd_bench(_args) -> int:
    print("daft_tpu_torch: the port's benchmark is not written yet (the reference's bench "
          "subcommand runs its bench.py); run chip_smoke.py on a card instead",
          file=sys.stderr)
    return 2


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the queries' device stages run (default cuda)")
    p = argparse.ArgumentParser(prog="daft_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("info", parents=[common])
    sp = sub.add_parser("sql", parents=[common])
    sp.add_argument("query")
    sp.add_argument("--table", "-t", action="append",
                    help="name=path bindings usable in the query")
    sp.add_argument("--limit", type=int, default=0)
    sp.add_argument("--json", action="store_true")
    sc = sub.add_parser("schema", parents=[common])
    sc.add_argument("path")
    sub.add_parser("bench", parents=[common])
    args = p.parse_args(argv)
    from .config import execution_config_ctx

    with execution_config_ctx(device=args.device):
        return {"info": _cmd_info, "sql": _cmd_sql, "schema": _cmd_schema,
                "bench": _cmd_bench}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
