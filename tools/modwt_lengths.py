"""K1 and K2 device time by row length, on the batch cell's requests.

    python3 tools/modwt_lengths.py [--tree DIR] [--reps 10] [--batch 1] [--lengths N ...]
                                   [--row-samples S ...] [--whole-row-max N ...]

From the root of a checkout, on a CUDA card. For each length n of
``benchmark/traffic/batch-64to8192.json`` (or ``--lengths``), one request of
the batch cell: ``samples // n`` float32 signals of n samples, at the
wavelet and level of ``benchmark/configs/modwt-db4-L5.json``. K1
(``modwt_cascade``) and then K2 (``imodwt_cascade``, on K1's coefficients)
are timed each on its own between CUDA events, warm (after one call of
each), ``--reps`` times; the median is the length's time. ``--batch``
times that many calls back to back in each timing, as a stream of requests
runs them, and divides. Where several plans are swept, they take turns in
every round. The bound is
``benchmark/roofline.py``'s for one kernel's work at that shape, so K1+K2's
bound is twice it. Prints one line a length and a JSON line with every
number, the card's name and power limit, and the launches a call makes (of
them on whole rows).

``--tree`` imports ``jwave_tpu_torch`` from another checkout (say the parent
commit's, unpacked by ``git archive``) to time its kernels by the same
method. ``--row-samples`` and ``--whole-row-max`` time the whole-row plan
at each budget of samples a block (``ops.cuda_modwt.ROW_SAMPLES``) and
longest whole row (``WHOLE_ROW_MAX``): the sweep those constants were
chosen from. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ms(fn, batch: int) -> float:
    """Device ms of one ``fn()``: ``batch`` calls back to back between CUDA
    events, over ``batch``."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(batch):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / batch


def _use(cm, plan):
    """Set the whole-row plan's constants (ROW_SAMPLES, WHOLE_ROW_MAX)."""
    if plan[0] is not None:
        cm.ROW_SAMPLES, cm.WHOLE_ROW_MAX = plan
        cm.rows_per_block.cache_clear()


def measure(cm, base_filters, lengths, samples, wavelet, level, reps, roofline, plans,
            batch=1):
    """Rows a length and plan: K1 and K2 ms, their bound and the launches of
    a call. The plans take turns within each round, so that a drift of the
    card's clock over the run falls on all of them alike."""
    import torch

    from jwave_tpu_torch import ops
    from jwave_tpu_torch.utils import profiling

    g0, h0 = base_filters(wavelet)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = torch.randn(samples, generator=gen, device="cuda")
    out = {plan: [] for plan in plans}
    for n in lengths:
        x = flat[:samples // n * n].view(-1, n)
        c = cm.modwt_cascade(x, g0, h0, level)
        k1 = {plan: [] for plan in plans}
        k2 = {plan: [] for plan in plans}
        counted = {}
        for plan in plans:  # warm, and count the launches of one call
            _use(cm, plan)
            before = ops.launch_counts(), profiling.counts()
            cm.modwt_cascade(x, g0, h0, level)
            cm.imodwt_cascade(c, g0, h0)
            counted[plan] = (before, (ops.launch_counts(), profiling.counts()))
        for _ in range(reps):
            for plan in plans:
                _use(cm, plan)
                k1[plan].append(_ms(lambda: cm.modwt_cascade(x, g0, h0, level), batch))
                k2[plan].append(_ms(lambda: cm.imodwt_cascade(c, g0, h0), batch))
        bound = 1e3 * roofline.bound_s(*roofline.modwt_cascade(x.shape[0], n, level, len(g0)))
        for plan in plans:
            _use(cm, plan)
            (b0, b1), (a0, a1) = counted[plan]
            t1, t2 = statistics.median(k1[plan]), statistics.median(k2[plan])
            rpb = getattr(cm, "rows_per_block", None)
            out[plan].append({
                "n": n, "rows": x.shape[0], "k1_ms": t1, "k2_ms": t2, "k1_k2_ms": t1 + t2,
                "bound_ms": 2 * bound, "share_pct": 100 * 2 * bound / (t1 + t2),
                "rows_per_block": rpb(n, level, 4) if rpb else 0,
                "launches": [a0[k] - b0[k] for k in ("K1", "K2")],
                "whole_row_launches": [a1.get(f"{k}.whole_row_launches", 0)
                                       - b1.get(f"{k}.whole_row_launches", 0)
                                       for k in ("K1", "K2")],
            })
        del x, c
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--lengths", type=int, nargs="+")
    ap.add_argument("--row-samples", type=int, nargs="+")
    ap.add_argument("--whole-row-max", type=int, nargs="+")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(args.tree.resolve()), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark import roofline
    from jwave_tpu_torch.ops import cuda_modwt as cm
    from jwave_tpu_torch.transforms.modwt import _modwt_base_filters

    mix = json.loads((ROOT / "benchmark/traffic/batch-64to8192.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/modwt-db4-L5.json").read_text())
    lengths = args.lengths or mix["lengths"]
    plans = [(s, w) for s in args.row_samples or [getattr(cm, "ROW_SAMPLES", None)]
             for w in args.whole_row_max or [getattr(cm, "WHOLE_ROW_MAX", None)]]
    card = roofline.card_line()
    results = measure(cm, _modwt_base_filters, lengths, mix["samples"], cfg["wavelet"],
                      cfg["level"], args.reps, roofline, plans, args.batch)
    for (budget, longest), rows in results.items():
        print(f"# {card}; tree {args.tree}; ROW_SAMPLES {budget}; WHOLE_ROW_MAX {longest}")
        print(f"{'n':>5} {'rows/blk':>8} {'K1 ms':>8} {'K2 ms':>8} {'K1+K2':>8} {'bound':>7} "
              f"{'%':>5} launches")
        for r in rows:
            print(f"{r['n']:>5} {r['rows_per_block']:>8} {r['k1_ms']:>8.4f} {r['k2_ms']:>8.4f} "
                  f"{r['k1_k2_ms']:>8.4f} {r['bound_ms']:>7.4f} {r['share_pct']:>5.1f} "
                  f"{r['launches']} whole {r['whole_row_launches']}")
        total = sum(r["k1_k2_ms"] for r in rows)
        print(json.dumps({"card": card, "tree": str(args.tree), "row_samples": budget,
                          "whole_row_max": longest,
                          "batch": args.batch,
                          "torch": torch.__version__, "cycle_ms": total,
                          "cycle_share_pct": 100 * sum(r["bound_ms"] for r in rows) / total,
                          "lengths": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
