"""NeighborhoodHash rounds on tensors.

The counterpart of ``grakel_tpu/kernels/neighborhood_hash.py:_nh_rounds``
(an XLA program there).  One round relabels every node from its own label
and its out-neighbours' labels (edge u -> v: v is a neighbour of u), all
in ``bits``-bit words:

* simple:          NH(u) = ROT1(l(u)) XOR (XOR over neighbour labels);
* count_sensitive: NH(u) = ROT1(l(u)) XOR (XOR over the distinct masked
  neighbour labels l, with count o, of ROT(l XOR o, o));

a node is poisoned (invalid) once its own label or any neighbour's is
invalid (a label unseen at fit), and poisoned nodes are still relabeled.
After each round every valid node adds one to its graph's histogram at
its new label.

:func:`nh_rounds` runs R rounds over a ``GraphBatch``'s sender CSR:
CUDA tensors launch the hand-written kernel K4 (``csrc/nh_hash.cu``)
once a round; CPU tensors take :func:`nh_rounds_plain`, the JAX
program's own method (bit-plane parity for the XOR aggregation, an edge
sort by (node, label) with run lengths for the count-sensitive fold) in
int64 torch ops.  Both give int32 histograms [R, n_graphs, 2^bits].

The JAX program sorts by the key ``send * 2^bits + label`` in uint32,
which wraps once N * 2^bits reaches 2^32; the plain version's key is
int64 and K4 keys nothing, so the packages can differ only there.
"""

from __future__ import annotations

import torch

__all__ = ["nh_rounds", "nh_rounds_plain", "nh_round_cuda", "rot_plain",
           "xor_segment_plain"]

_M32 = 0xFFFFFFFF


def rot_plain(x, d, bits):
    """ROT of ``x`` by ``d`` in ``bits``-bit words, on int64 tensors
    holding u32 values: ``_rot`` of the JAX package exactly, including
    its ``d % bits == 0`` case, which returns ``x`` unmasked."""
    mask = (1 << bits) - 1
    m = torch.as_tensor(d, dtype=torch.int64, device=x.device) % bits
    r = ((x << m) & mask) | ((x & mask) >> torch.where(m > 0, bits - m, 0))
    return torch.where(m > 0, r, x)


def xor_segment_plain(values, segment_ids, num_segments, bits):
    """XOR of the low ``bits`` bits of int64 ``values`` per segment, by
    bit-plane parity (one ``index_add_`` a plane), as ``_xor_segment`` of
    the JAX package.  Returns int64 [num_segments]."""
    out = torch.zeros(num_segments, dtype=torch.int64, device=values.device)
    for b in range(bits):
        s = torch.zeros(num_segments, dtype=torch.int64,
                        device=values.device)
        s.index_add_(0, segment_ids, (values >> b) & 1)
        out |= (s & 1) << b
    return out


def _senders(csr_offsets, n):
    off = csr_offsets.to(torch.int64)
    return torch.repeat_interleave(torch.arange(n, device=off.device),
                                   off[1:n + 1] - off[:n])


def _histogram(hist, gids, lab, valid, L):
    """hist[g, l] += 1 for every valid node of graph g with label l."""
    seg = gids[valid].to(torch.int64) * L + lab[valid]
    hist.view(-1).index_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))


def nh_rounds_plain(lab, lab_valid, gids, csr_offsets, csr_targets,
                    n_graphs, R, bits, count_sensitive):
    """R NeighborhoodHash rounds in plain PyTorch (int64), on any device.

    ``lab`` int32 [N] (u32 bit patterns), ``lab_valid`` bool [N] (False
    on padding nodes too), ``gids`` int32 [N] (a padding node may carry
    any id: it is never valid), and the sender CSR over the N nodes.
    Returns int32 histograms [R, n_graphs, 2^bits]."""
    n = lab.shape[0]
    L = 1 << bits
    mask = L - 1
    send = _senders(csr_offsets, n)
    recv = csr_targets[:send.shape[0]].to(torch.int64)
    l = lab.to(torch.int64) & _M32
    valid = lab_valid.to(torch.bool)
    hists = torch.zeros((R, n_graphs, L), dtype=torch.int32,
                        device=lab.device)
    for r in range(R):
        bad = torch.zeros(n, dtype=torch.int64, device=l.device)
        bad.index_add_(0, send, (~valid[recv]).to(torch.int64))
        valid = valid & (bad == 0)
        if not count_sensitive:
            agg = xor_segment_plain(l[recv], send, n, bits)
        else:
            # distinct (node, masked neighbour label) runs with their
            # lengths o, each folded as ROT(l ^ o, o)
            key, o = torch.unique(send * L + (l[recv] & mask),
                                  return_counts=True)
            agg = xor_segment_plain(rot_plain((key & mask) ^ o, o, bits),
                                    key >> bits, n, bits)
        l = (rot_plain(l & mask, 1, bits) ^ agg) & mask
        _histogram(hists[r], gids, l, valid, L)
    return hists


def nh_round_cuda(lab, lab_valid, gids, csr_offsets, csr_targets, hist,
                  bits, count_sensitive):
    """Launch K4 (``csrc/nh_hash.cu``): one NeighborhoodHash round.

    ``lab`` int32 [N], ``lab_valid`` bool [N], ``gids`` int32 [N] (ids
    of valid nodes in [0, n_graphs)), ``csr_offsets`` int32 [N + 1],
    ``csr_targets`` int32 [E] and ``hist`` int32 [n_graphs, 2^bits], all
    contiguous CUDA tensors on one device.  The CSR is trusted, as K2's
    (``GraphBatch`` checks it once).  Adds the round's counts into
    ``hist`` and returns the new (labels, validity)."""
    from .. import _build
    dev = lab.device
    n = lab.shape[0]
    ts = (lab, lab_valid, gids, csr_offsets, csr_targets, hist)
    types = (torch.int32, torch.bool, torch.int32, torch.int32, torch.int32,
             torch.int32)
    if not (dev.type == "cuda"
            and all(t.device == dev and t.dtype == d and t.is_contiguous()
                    for t, d in zip(ts, types))
            and lab.dim() == lab_valid.dim() == gids.dim() == 1
            and csr_offsets.dim() == csr_targets.dim() == 1
            and lab_valid.shape[0] == gids.shape[0] == n
            and csr_offsets.shape[0] == n + 1 and n < 1 << 30
            and 1 <= bits <= 30 and hist.dim() == 2
            and hist.shape[1] == 1 << bits):
        raise ValueError("nh_round_cuda: need contiguous CUDA tensors on one "
                         "device: int32 lab [N], bool lab_valid [N], int32 "
                         "gids [N], int32 csr_offsets [N + 1] and "
                         "csr_targets [E], int32 hist [n_graphs, 2^bits], "
                         "1 <= bits <= 30, N < 2^30")
    new_lab = torch.empty_like(lab)
    new_valid = torch.empty_like(lab_valid)
    _build.launch("grakel_nh_round", dev, lab.data_ptr(),
                  lab_valid.data_ptr(), gids.data_ptr(),
                  csr_offsets.data_ptr(), csr_targets.data_ptr(),
                  new_lab.data_ptr(), new_valid.data_ptr(), hist.data_ptr(),
                  n, hist.shape[0], bits, int(bool(count_sensitive)))
    nh_round_cuda.launches += 1
    return new_lab, new_valid


nh_round_cuda.launches = 0


def nh_rounds(batch, lab, lab_valid, n_graphs, R, bits, count_sensitive):
    """R NeighborhoodHash rounds over ``batch``'s sender CSR: int32
    histograms [R, n_graphs, 2^bits] on the batch's device.  ``lab``
    int32 [N_pad] and ``lab_valid`` bool [N_pad] (False on padding) live
    there too.  CUDA tensors launch K4 once a round; CPU tensors take
    :func:`nh_rounds_plain`."""
    gids = batch.node_graph_ids
    csr = (batch.csr_offsets, batch.csr_targets)
    dev = lab.device
    if dev.type == "cpu":
        return nh_rounds_plain(lab, lab_valid, gids, *csr, n_graphs, R,
                               bits, count_sensitive)
    if dev.type != "cuda":
        raise ValueError("nh_rounds: unsupported device %s" % dev)
    hists = torch.zeros((R, n_graphs, 1 << bits), dtype=torch.int32,
                        device=dev)
    for r in range(R):
        lab, lab_valid = nh_round_cuda(lab, lab_valid, gids, *csr, hists[r],
                                       bits, count_sensitive)
    return hists
