"""Offline CTC-posterior distribution analysis.

Counterpart of ``ps_slm_tpu/tools/posterior_analysis.py`` (numpy, every
function and the CLI), a re-implementation of
``Multitask/utils/distribution_analysis.py`` (the research tool used to
validate the TASU hypothesis): given pairs of real CTC
posteriors and simulated (clean / CPS-noised) pseudo-posteriors, compute

  * frame-mean Jensen-Shannon distance (after length interpolation)
  * symmetric cross-entropy
  * top-1 agreement rate
  * CTC-collapse edit distance (argmax -> collapse -> blank-drop)
  * blank fraction and mean entropy

Two HDF5 layouts are accepted:

  * **triplet layout** (the reference's, ``distribution_analysis.py:131-184``):
    top-level groups ``ctc`` / ``clean`` / ``noise``, each holding per-key
    logit datasets [T, V].  Metrics are computed for the three pairs
    (ctc,clean), (ctc,noise), (noise,clean) plus the headline
    ``delta = JS(ctc,noise) - JS(ctc,clean)``, fanned out over a process
    pool, written to a per-utterance CSV, and summarized in three scatter
    plots (reference ``:226-257``).
  * **pair layout**: one group per utterance with datasets ``real`` [T1, V]
    and ``sim`` [T2, V] (probabilities), aggregated to a JSON summary.

CLI: ``python -m ps_slm_tpu_torch.tools.posterior_analysis cache.h5 [out_dir|out.json] [--jobs N]``.
``h5py`` (the caches) and ``matplotlib`` (the plots) are imported only
where they are used.
"""

from __future__ import annotations

import csv
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

EPS = 1e-10
PAIRS = (("ctc", "clean"), ("ctc", "noise"), ("noise", "clean"))


def interp_to_length(post: np.ndarray, t_out: int) -> np.ndarray:
    """Linear time interpolation then renormalize (reference
    interp_logits_then_softmax semantics on probability inputs)."""
    t_in, v = post.shape
    if t_in == t_out:
        out = post
    else:
        x_out = np.linspace(0.0, 1.0, t_out)
        x_in = np.linspace(0.0, 1.0, t_in)
        out = np.stack([np.interp(x_out, x_in, post[:, j]) for j in range(v)], 1)
    s = out.sum(-1, keepdims=True)
    return out / np.maximum(s, EPS)


def js_distance_frame_mean(p: np.ndarray, q: np.ndarray) -> float:
    """Mean over frames of the JS distance (sqrt of JS divergence, log2)."""
    m = 0.5 * (p + q)

    def kl(a, b):
        return np.sum(a * (np.log2(a + EPS) - np.log2(b + EPS)), axis=-1)

    js = 0.5 * kl(p, m) + 0.5 * kl(q, m)
    return float(np.mean(np.sqrt(np.clip(js, 0, None))))


def symmetric_ce(p: np.ndarray, q: np.ndarray) -> float:
    ce_pq = -np.sum(p * np.log(q + EPS), axis=-1)
    ce_qp = -np.sum(q * np.log(p + EPS), axis=-1)
    return float(np.mean(0.5 * (ce_pq + ce_qp)))


def top1_agreement(p: np.ndarray, q: np.ndarray) -> float:
    return float(np.mean(p.argmax(-1) == q.argmax(-1)))


def collapse_ctc(post: np.ndarray, blank: int = 0) -> List[int]:
    ids = post.argmax(-1)
    out = []
    prev = None
    for i in ids:
        if i != prev and i != blank:
            out.append(int(i))
        prev = i
    return out


def edit_distance(a: List[int], b: List[int]) -> int:
    la, lb = len(a), len(b)
    dp = list(range(lb + 1))
    for i in range(1, la + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, lb + 1):
            cur = dp[j]
            dp[j] = min(
                dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1])
            )
            prev = cur
    return dp[lb]


def blank_fraction(post: np.ndarray, blank: int = 0) -> float:
    return float(np.mean(post.argmax(-1) == blank))


def mean_entropy(post: np.ndarray) -> float:
    return float(np.mean(-np.sum(post * np.log(post + EPS), axis=-1)))


def analyze_pair(
    real: np.ndarray, sim: np.ndarray, blank: int = 0
) -> Dict[str, float]:
    """All metrics for one (real, simulated) posterior pair."""
    sim_i = interp_to_length(sim, real.shape[0])
    real_n = real / np.maximum(real.sum(-1, keepdims=True), EPS)
    c_real = collapse_ctc(real_n, blank)
    c_sim = collapse_ctc(sim / np.maximum(sim.sum(-1, keepdims=True), EPS),
                         blank)
    ed = edit_distance(c_real, c_sim)
    return {
        "js": js_distance_frame_mean(real_n, sim_i),
        "sce": symmetric_ce(real_n, sim_i),
        "top1": top1_agreement(real_n, sim_i),
        "edit": ed,
        "edit_norm": ed / max(len(c_real), 1),
        "blank_frac_real": blank_fraction(real_n, blank),
        "blank_frac_sim": blank_fraction(sim, blank),
        "entropy_real": mean_entropy(real_n),
        "entropy_sim": mean_entropy(sim),
    }


def interp_logits_then_softmax(logits: np.ndarray, t_out: int) -> np.ndarray:
    """Interpolate *logits* in time then softmax (the reference convention,
    ``distribution_analysis.py:44-56`` — triplet caches store logits)."""
    t_in, v = logits.shape
    if t_in != t_out:
        x_out = np.linspace(0.0, 1.0, t_out)
        x_in = np.linspace(0.0, 1.0, t_in)
        logits = np.stack(
            [np.interp(x_out, x_in, logits[:, j]) for j in range(v)], 1
        )
    z = logits - logits.max(-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(-1, keepdims=True)


def pair_metrics(
    p: np.ndarray, q: np.ndarray, a: str, b: str, blank: int = 0
) -> Dict[str, float]:
    """Prefixed metric dict for one (p, q) probability pair — the per-pair
    stats block of the reference worker (``distribution_analysis.py:146-177``)."""
    seq_p = collapse_ctc(p, blank)
    seq_q = collapse_ctc(q, blank)
    ed = edit_distance(seq_p, seq_q)
    pre = f"{a}_{b}"
    return {
        f"{pre}_js": js_distance_frame_mean(p, q),
        f"{pre}_sce": symmetric_ce(p, q),
        f"{pre}_top1_acc": top1_agreement(p, q),
        f"{pre}_entropy_{a}": mean_entropy(p),
        f"{pre}_entropy_{b}": mean_entropy(q),
        f"{pre}_blank_frac_{a}": blank_fraction(p, blank),
        f"{pre}_blank_frac_{b}": blank_fraction(q, blank),
        f"{pre}_edit_dist": float(ed),
        f"{pre}_edit_norm": ed / max(1, max(len(seq_p), len(seq_q))),
        f"{pre}_len_{a}": float(len(seq_p)),
        f"{pre}_len_{b}": float(len(seq_q)),
    }


def _triplet_worker(args) -> Dict[str, float]:
    """Per-key metrics over all three pairs; top-level so it pickles into a
    multiprocessing pool (reference ``_worker``, ``:131-184``)."""
    path, key, blank = args
    import h5py

    out: Dict[str, float] = {"key": key}
    with h5py.File(path, "r") as f:
        posts = {}
        for g in ("ctc", "clean", "noise"):
            posts[g] = np.asarray(f[g][key], np.float64)
        for a, b in PAIRS:
            t = max(posts[a].shape[0], posts[b].shape[0])
            p = interp_logits_then_softmax(posts[a], t)
            q = interp_logits_then_softmax(posts[b], t)
            out.update(pair_metrics(p, q, a, b, blank))
    out["delta"] = out["ctc_noise_js"] - out["ctc_clean_js"]
    return out


def _scatter(x, y, xlabel, ylabel, title, path, hline: Optional[float] = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(5, 3.5))
    plt.scatter(x, y, s=10, alpha=0.6)
    if hline is not None:
        plt.axhline(hline, lw=1, ls="--")
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.title(title)
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()


def analyze_triplet_h5(
    path: str, out_dir: str, blank: int = 0, jobs: Optional[int] = None,
    plots: bool = True,
) -> Dict[str, float]:
    """Reference main flow (``distribution_analysis.py:187-257``): process-pool
    fan-out over keys, per-utterance CSV, delta summary, three scatter plots."""
    import h5py
    from multiprocessing import Pool, cpu_count

    with h5py.File(path, "r") as f:
        keys = sorted(f["ctc"].keys())
    if not keys:
        raise ValueError(f"no keys under group 'ctc' in {path}")

    work = [(path, k, blank) for k in keys]
    n_jobs = jobs or min(cpu_count(), len(keys))
    if n_jobs > 1:
        with Pool(n_jobs) as pool:
            rows = list(pool.imap(_triplet_worker, work))
    else:
        rows = [_triplet_worker(w) for w in work]

    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "pair_metrics_per_utt.csv")
    fields = ["key"] + [k for k in rows[0] if k != "key"]
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)

    deltas = np.asarray([r["delta"] for r in rows], np.float32)
    summary = {
        "n_utts": len(rows),
        "delta_mean": float(deltas.mean()),
        "delta_neg_frac": float((deltas < 0).mean()),
        "csv": csv_path,
    }
    if plots:
        x = np.asarray([r["ctc_clean_js"] for r in rows], np.float32)
        _scatter(
            x, deltas, "JS(CTC, Clean)",
            "delta = JS(CTC, Noise) - JS(CTC, Clean)",
            "Noise closer to CTC?  (delta < 0 -> yes)",
            os.path.join(out_dir, "delta_ctc_noise_clean.png"), hline=0.0,
        )
        _scatter(
            x, np.asarray([r["ctc_clean_top1_acc"] for r in rows], np.float32),
            "JS(CTC, Clean)", "Top-1 frame acc (CTC vs Clean)",
            "shape divergence vs decision agreement",
            os.path.join(out_dir, "js_vs_top1acc_ctc_clean.png"),
        )
        _scatter(
            x, np.asarray([r["ctc_clean_edit_norm"] for r in rows], np.float32),
            "JS(CTC, Clean)", "Norm edit distance (CTC vs Clean)",
            "shape divergence vs sequence divergence",
            os.path.join(out_dir, "js_vs_editnorm_ctc_clean.png"),
        )
        summary["plots"] = [
            os.path.join(out_dir, n) for n in (
                "delta_ctc_noise_clean.png", "js_vs_top1acc_ctc_clean.png",
                "js_vs_editnorm_ctc_clean.png",
            )
        ]
    return summary


def analyze_h5(path: str, blank: int = 0) -> Dict[str, float]:
    import h5py

    per_utt = []
    with h5py.File(path, "r") as f:
        for key in f.keys():
            g = f[key]
            if "real" in g and "sim" in g:
                per_utt.append(
                    analyze_pair(np.asarray(g["real"]), np.asarray(g["sim"]),
                                 blank)
                )
    if not per_utt:
        raise ValueError(f"no (real, sim) pairs in {path}")
    agg = {k: float(np.mean([u[k] for u in per_utt])) for k in per_utt[0]}
    agg["n_utts"] = len(per_utt)
    return agg


def _is_triplet(path: str) -> bool:
    import h5py

    with h5py.File(path, "r") as f:
        return all(g in f for g in ("ctc", "clean", "noise"))


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    jobs = None
    if "--jobs" in argv:
        i = argv.index("--jobs")
        jobs = int(argv[i + 1])
        del argv[i:i + 2]
    if not argv:
        print(
            "usage: python -m ps_slm_tpu_torch.tools.posterior_analysis "
            "cache.h5 [out_dir|out.json] [--jobs N]"
        )
        return 2
    if _is_triplet(argv[0]):
        out_dir = argv[1] if len(argv) > 1 else "posterior_analysis"
        stats = analyze_triplet_h5(argv[0], out_dir, jobs=jobs)
        print(json.dumps(stats, indent=2))
        print(f"delta mean: {stats['delta_mean']:.3f}")
        print(f"delta < 0 fraction: {stats['delta_neg_frac'] * 100:.1f}%")
        return 0
    stats = analyze_h5(argv[0])
    text = json.dumps(stats, indent=2)
    print(text)
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
