"""The pipelined executor's costs on the card, beside chip_smoke.py's
pipeline phase.

    python3 pipeline_timings.py [--phase] [--threads] [--ai]

- ``--phase``: chip_smoke.py's pipeline phase alone (the card, the kernels'
  build, the SF1 tables, the in-memory cells' results, the scan phase's
  files, then ``chip_smoke.phase_pipeline``), in about 5 minutes.
- ``--threads``: what a stage thread costs: a large ``tolist`` on this
  thread, on fresh threads and on a kept one (and the same with
  ``MALLOC_ARENA_MAX=1``); a thread's start and join, with and without a
  first CUDA call on it, against the call on this thread; then the
  in-memory q1 and supplier cells' warm runs under
  pipeline_mode "off", "on", and "on" with a 0.5 ms switch interval, in
  turns (7 runs each, twice).
- ``--ai``: the ai embed cell's warm runs under "off" and "on" in turns
  (off, on, on, off, twice), and one run of each under torch.profiler
  (``chip_smoke.ai_profile``: host tokenization, device busy, idle share)
  and one under cProfile (``chip_smoke.host_profile``).

With no flag it runs all three. It needs a CUDA card and imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def phase(cs, card: str) -> None:
    import daft_tpu_torch as dt

    t0 = time.perf_counter()
    lineitem, orders, dims = cs.tpch_sf1(cs.SEED)
    print(f"datagen {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    tails = cs.tails_frames(lineitem, orders, dims)
    q6 = dt.from_pydict({**{c: lineitem[c] for c in ("l_quantity", "l_extendedprice",
                                                     "l_discount")},
                         "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})
    with cs.dt_ctx():
        cells = {"q1": cs.q1_query(cs.q1_frame(lineitem)).to_pydict(),
                 "q6": cs.q6_query(q6).to_pydict(),
                 "q12": cs.q12_query(*cs.q12_frames(lineitem, orders)).to_pydict(),
                 "q14": cs.q14_query(tails).to_pydict(),
                 "q3": cs.q3_query(tails).to_pydict(),
                 "q5": cs.q5_query(cs.q5_frames(lineitem, orders, dims)).to_pydict(),
                 "supplier": cs.supplier_query(cs.supplier_frame(lineitem)).to_pydict()}
    cs.check(cells["supplier"] == cs.numpy_oracle(lineitem),
             "supplier differs from its numpy oracle")
    print(f"cells {time.perf_counter() - t0:.1f} s", flush=True)
    del tails, q6
    root = tempfile.mkdtemp(prefix="daft_tpu_torch_scan_")
    try:
        dirs = cs.scan_write(cs.scan_tables(lineitem, orders, dims), root, card)
        cs.phase_pipeline(lineitem, orders, dirs, cells, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _on_thread(fn, n: int = 20):
    """Median and largest ms of starting a thread that runs ``fn`` and
    joining it."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        t = threading.Thread(target=fn)
        t.start()
        t.join()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), max(out)


def tolist_times(label: str) -> None:
    """Seconds of one large allocation-heavy host step, an embedding
    output's ``tolist`` (65,536 x 384 f32 into Python floats), on this
    thread, on a fresh thread each time, and on one kept thread, three
    times each."""
    import queue

    import numpy as np

    a = np.random.default_rng(0).random((65536, 384), dtype=np.float32)

    def work():
        t0 = time.perf_counter()
        x = a.tolist()
        secs = time.perf_counter() - t0
        del x
        return secs

    def fresh():
        out = []
        t = threading.Thread(target=lambda: out.append(work()))
        t.start()
        t.join()
        return out[0]

    todo, done = queue.SimpleQueue(), queue.SimpleQueue()

    def kept_loop():
        while todo.get():
            done.put(work())

    threading.Thread(target=kept_loop, daemon=True).start()

    def kept():
        todo.put(True)
        return done.get()

    for _ in range(3):
        print(f"tolist ({label}): this thread {work():.3f} s, a fresh thread {fresh():.3f} s, "
              f"a kept thread {kept():.3f} s", flush=True)
    todo.put(False)


def threads(cs, card: str) -> None:
    import subprocess

    import torch

    import daft_tpu_torch as dt

    cs.phase("threads")
    tolist_times("the process's allocator")
    # the same with one allocator arena for every thread
    subprocess.run([sys.executable, os.path.abspath(__file__), "--tolist"], check=True,
                   env={**os.environ, "MALLOC_ARENA_MAX": "1"})

    def cuda_call():
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()

    cuda_call()
    print("thread start and join, nothing run: %.4f ms median (max %.4f)"
          % _on_thread(lambda: None))
    print("thread start and join, a CUDA call and a synchronize on it: %.4f ms median "
          "(max %.4f)" % _on_thread(cuda_call))
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        cuda_call()
        ts.append((time.perf_counter() - t0) * 1e3)
    print(f"the same CUDA call on this thread: {statistics.median(ts):.4f} ms median "
          f"[{card}]", flush=True)
    lineitem, _orders, _dims = cs.tpch_sf1(cs.SEED)
    q1_df = cs.q1_frame(lineitem)
    sup = cs.supplier_frame(lineitem)
    for label, run in (("q1", lambda: cs.q1_query(q1_df).to_pydict()),
                       ("supplier", lambda: cs.supplier_query(sup).to_pydict())):
        res = {}
        with cs.dt_ctx():
            run()
            turns = (("off", None), ("on", None), ("on, 0.5 ms switch", 5e-4)) * 2
            for mode, interval in turns:
                prev = sys.getswitchinterval()
                if interval:
                    sys.setswitchinterval(interval)
                try:
                    with dt.execution_config_ctx(pipeline_mode=mode.split(",")[0]):
                        for _ in range(7):
                            t0 = time.perf_counter()
                            run()
                            torch.cuda.synchronize()
                            res.setdefault(mode, []).append((time.perf_counter() - t0) * 1e3)
                finally:
                    sys.setswitchinterval(prev)
        for mode, ts in res.items():
            print(f"{label} {mode}: warm median {statistics.median(ts):.3f} ms, min "
                  f"{min(ts):.3f} ms ({len(ts)} runs) [{card}]", flush=True)


def ai(cs, card: str) -> None:
    import torch

    import daft_tpu_torch as dt

    cs.phase("ai off and on")
    emb = cs.install_ai_model()
    df = cs.ai_frame(cs.ai_corpus(cs.SEED, cs.AI_ROWS))
    with cs.dt_ctx():
        cs.ai_embed_query(df).to_pydict()
    times = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * 2:
        with cs.dt_ctx(), dt.execution_config_ctx(pipeline_mode=mode):
            t0 = time.perf_counter()
            cs.ai_embed_query(df).to_pydict()
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
    for mode, ts in times.items():
        print(f"ai embed {mode}: warm median {statistics.median(ts):.4f} s (runs "
              f"{', '.join(f'{t:.4f}' for t in ts)}) [{card}]", flush=True)
    for mode in ("off", "on"):
        with dt.execution_config_ctx(pipeline_mode=mode):
            print(f"ai embed profile, pipeline_mode {mode}:")
            cs.ai_profile(lambda: cs.ai_embed_query(df).to_pydict(), emb, card)
            with cs.dt_ctx():
                cs.host_profile(f"ai embed, pipeline_mode {mode}",
                                lambda: cs.ai_embed_query(df).to_pydict(), card, top=15)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", action="store_true")
    parser.add_argument("--threads", action="store_true")
    parser.add_argument("--ai", action="store_true")
    parser.add_argument("--tolist", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tolist:
        tolist_times(f"MALLOC_ARENA_MAX={os.environ.get('MALLOC_ARENA_MAX')}")
        return 0
    chosen = [name for name in ("phase", "threads", "ai") if getattr(args, name)] or \
        ["phase", "threads", "ai"]
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    try:
        card, _name = cs.phase_card()
        cs.phase_build(card)
        for name in chosen:
            {"phase": phase, "threads": threads, "ai": ai}[name](cs, card)
    except cs.SmokeFailure as exc:
        print(f"pipeline_timings.py: FAILED: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
