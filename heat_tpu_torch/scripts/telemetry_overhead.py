"""What telemetry costs the host on the 10-op eager chain.

Runs the chain of ``tests/test_telemetry.py`` (nine elementwise ops and a
sum, each chain ending in one host read) at a small size, where the host
sets the pace, with telemetry off, at mode 1 and verbose, in rounds that
alternate the modes; prints each round's ops/s and its mode 1 / off ratio,
then the nanoseconds per call of the record seams one chain passes at
mode 1, as one JSON line. ``chip_smoke.py``'s phase 16 holds the best
round's ratio to at least 0.9.

    python -m heat_tpu_torch.scripts.telemetry_overhead [--device cuda] [--rounds 5]

Run it against another tree of the package with ``PYTHONPATH`` pointing
there and the script given by its path.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import timeit


def _chain(ht, a, b):
    c = (a + b) * 2.0
    c = ht.exp(c)
    c = c - b
    d = ht.abs(c)
    e = d + a
    f = ht.sqrt(ht.abs(e))
    g = f / (d + 1.0)
    h = g * b
    return ht.sum(h)


def _rate(ht, a, b, reps: int, trials: int) -> float:
    """Ops per second, the best of ``trials`` runs of ``reps`` chains."""
    float(_chain(ht, a, b).larray)
    best = math.inf
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            float(_chain(ht, a, b).larray)
        best = min(best, time.perf_counter() - t0)
    return 10.0 * reps / best


def _seams(tel, health_runtime, memledger, number: int) -> dict:
    """Nanoseconds per call of each record seam at mode 1, the best of five."""
    calls = {
        "record_dispatch": lambda: tel.record_dispatch("binary", True),
        "record_force": lambda: tel.record_force("parray", 10, False, 1),
        "record_async_dispatch": lambda: tel.record_async_dispatch(1, cid=1, cids=[1], program="p"),
        "record_fused_collective": lambda: tel.record_fused_collective("reduce.psum", cid=1),
        "blocking_sync": lambda: tel.end_blocking_sync(tel.record_blocking_sync("item", cid=1)),
        "note_dispatch": lambda: health_runtime.note_dispatch("p", [1], False, 1e-5),
        "memory_note": lambda: memledger.note("dispatch"),
    }
    prev = tel.set_mode(1)
    try:
        return {name: min(timeit.repeat(fn, number=number, repeat=5)) / number * 1e9 for name, fn in calls.items()}
    finally:
        tel.set_mode(prev)
        tel.reset()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rows", type=int, default=1_000)
    parser.add_argument("--cols", type=int, default=16)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--reps", type=int, default=8)
    parser.add_argument("--trials", type=int, default=5)
    parser.add_argument("--seam-calls", type=int, default=20_000)
    args = parser.parse_args(argv)

    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import health_runtime, memledger
    from heat_tpu_torch.core import telemetry as tel

    gen = torch.Generator(device=args.device).manual_seed(0)
    a, b = (ht.array(torch.randn((args.rows, args.cols), generator=gen, device=args.device), split=0,
                     device=args.device)
            for _ in range(2))
    rounds = []
    for _ in range(args.rounds):
        rates = {}
        for mode, name in ((0, "off"), (1, "on"), (2, "verbose")):
            tel.set_mode(mode)
            tel.reset()
            rates[name] = _rate(ht, a, b, args.reps, args.trials)
        rates["on_off"] = rates["on"] / rates["off"]
        rounds.append(rates)
    tel.set_mode(0)
    tel.reset()
    best = {name: max(r[name] for r in rounds) for name in ("off", "on", "verbose")}
    out = {
        "shape": [args.rows, args.cols],
        "device": args.device,
        "rounds": rounds,
        "best_round_on_off": max(r["on_off"] for r in rounds),
        "us_per_chain_added_at_mode_1": 10e6 / best["on"] - 10e6 / best["off"],
        "seam_ns": _seams(tel, health_runtime, memledger, args.seam_calls),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
