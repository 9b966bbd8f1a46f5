"""What the plain references of the configurations share: an exact
counts-Gram from feature occurrences, and GraKeL's normalization.

Plain NumPy and PyTorch; imports nothing of grakel_torch.  On a card
the counts-Gram runs as dense f64 products over blocks of feature
columns (every count, and every sum of products of counts, is an integer
well under 2^53, so each entry is exact); on the CPU the same products
run in small blocks.  ``dtype`` lets a control compute it in a lower
precision.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["counts_gram", "normalize", "no_tf32"]


def no_tf32():
    """Keep float32 products in float32 on a card (PyTorch may run them
    in TF32 otherwise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def counts_gram(gids, fids, n, device="cpu", dtype=torch.float64,
                block=4096):
    """K[a, b] = sum over features f of c[a, f] c[b, f], where c[a, f]
    counts the items (a, f) among ``gids`` (graph of each item) and
    ``fids`` (its feature id, any int64).  Returns a numpy [n, n] array
    of ``dtype``'s numpy type."""
    no_tf32()
    gids = np.asarray(gids, np.int64)
    fids = np.asarray(fids, np.int64)
    _, col = np.unique(fids, return_inverse=True)
    col = col.reshape(-1)
    pair, cnt = np.unique(col * n + gids, return_counts=True)
    pcol, pg = pair // n, pair % n
    # a feature that one graph holds adds only to that graph's diagonal
    held = np.bincount(pcol)
    one = held[pcol] == 1
    diag = np.bincount(pg[one], weights=cnt[one].astype(np.float64) ** 2,
                       minlength=n)
    _, pcol = np.unique(pcol[~one], return_inverse=True)
    pcol, pg, cnt = pcol.reshape(-1), pg[~one], cnt[~one]
    ncol = int(pcol[-1]) + 1 if pcol.shape[0] else 0
    K = torch.diag(torch.from_numpy(diag)).to(device=device, dtype=dtype)
    starts = np.searchsorted(pcol, np.arange(0, ncol + block, block))
    for b, c0 in enumerate(range(0, ncol, block)):
        s0, s1 = int(starts[b]), int(starts[b + 1])
        width = min(block, ncol - c0)
        C = torch.zeros((n, width), dtype=dtype, device=device)
        g = torch.from_numpy(pg[s0:s1]).to(device)
        c = torch.from_numpy(pcol[s0:s1] - c0).to(device)
        C[g, c] = torch.from_numpy(cnt[s0:s1]).to(device=device,
                                                     dtype=dtype)
        K.addmm_(C, C.T)
    return K.cpu().numpy()


def normalize(K, dtype=np.float64):
    """GraKeL's normalization, K[a, b] / sqrt(K[a, a] K[b, b]), 0 where a
    diagonal entry is 0, in ``dtype``."""
    K = np.asarray(K, dtype)
    d = np.diagonal(K).copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        out = K / np.sqrt(np.outer(d, d))
    return np.nan_to_num(out)
