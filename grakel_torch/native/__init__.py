"""The port's native (C++) host engines, loaded with ``ctypes``.

Copies of the JAX package's engines (``native/src/*.cpp``, byte for byte
the same sources, so fingerprints and hashes are bit-identical and a
fitted state carries across): the combinatorial algorithms that are
not tensor-shaped (recursive backtracking, BFS decompositions, string
hashing).  They build at first use into ``build/native/`` with ``g++``
(:func:`grakel_torch._build.build_native`); a failed build raises with
the compiler's output.  The plain Python versions
(:func:`_clique_values_py`, :func:`_ap_hash_py`) are what the tests
hold the engines against.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

__all__ = ["have_native", "clique_values", "ap_hash_batch",
           "connected_subsets_native",
           "nspd_hash_graph", "canonical_labeling_native",
           "odd_sth_decompose_native", "sp_bfs_counts_native"]

_lib = None
_LOCK = threading.Lock()


def _declare(lib):
    """argtypes and restype of every entry point."""
    _f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    _i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    _i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    _u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    _u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    _pp = ctypes.POINTER
    lib.clique_values.argtypes = [ctypes.c_int, ctypes.c_int,
                                  _f64, _f64, _f64]
    lib.clique_values.restype = None
    lib.ap_hash_batch.argtypes = [ctypes.c_long, _u8, _i64, _u32]
    lib.ap_hash_batch.restype = None
    lib.consubg.argtypes = [ctypes.c_int, _i32, _i32, ctypes.c_int,
                            _pp(_pp(ctypes.c_int))]
    lib.consubg.restype = ctypes.c_long
    lib.consubg_free.argtypes = [_pp(ctypes.c_int)]
    lib.consubg_free.restype = None
    lib.nspd_hash_graph.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long, _i32, _i32,
        ctypes.c_long, _i32, _i32,
        _u8, _i64, _u8, _i64,
        _u32, ctypes.c_long, _i32, _i32, _i32]
    lib.nspd_hash_graph.restype = ctypes.c_long
    lib.canonical_labeling.argtypes = [
        ctypes.c_int, ctypes.c_long, _i32, _i32, _i32, ctypes.c_int, _i32]
    lib.canonical_labeling.restype = ctypes.c_int
    lib.odd_sth_decompose.argtypes = [
        ctypes.c_int, _i64, _i64, _i32, _i64, _i64, ctypes.c_int,
        _pp(_pp(ctypes.c_uint64)), _pp(_pp(ctypes.c_uint64)),
        _pp(_pp(ctypes.c_int64)),
        _pp(_pp(ctypes.c_int32)), _pp(_pp(ctypes.c_int32)),
        _pp(_pp(ctypes.c_int64)), _pp(ctypes.c_int64)]
    lib.odd_sth_decompose.restype = ctypes.c_int64
    lib.odd_sth_free.argtypes = [ctypes.c_void_p]
    lib.odd_sth_free.restype = None
    lib.sp_bfs_counts.argtypes = [
        ctypes.c_int, _i64, _i64, _i32, _i32,
        ctypes.c_longlong, ctypes.c_longlong,
        _pp(_pp(ctypes.c_int32)), _pp(_pp(ctypes.c_int64)),
        _pp(_pp(ctypes.c_int64)), _pp(ctypes.c_int64)]
    lib.sp_bfs_counts.restype = ctypes.c_int64
    lib.sp_bfs_free.argtypes = [ctypes.c_void_p]
    lib.sp_bfs_free.restype = None


def _load():
    """The loaded native library (built on first call); raises with the
    compiler's output when it cannot be built."""
    global _lib
    with _LOCK:
        if _lib is None:
            from .._build import build_native
            lib = ctypes.CDLL(build_native())
            _declare(lib)
            _lib = lib
    return _lib


def have_native():
    """Whether the engines build and load here: a query only (every
    engine still raises with the compiler's output when they cannot)."""
    try:
        _load()
    except Exception:
        return False
    return True


def _clique_values_py(nv, kmax, cv, ce, tv):
    """Plain Python version of the native clique enumeration, with the
    same enumeration order (the tests hold the engine against it)."""
    def expand(value, clique, P, D):
        for pi, v in enumerate(P):
            ev = ce[v]
            val = value * cv[v]
            for m in clique:
                val *= abs(ev[m])
            tv[len(clique)] += val
            if len(clique) + 1 < kmax:
                newP = [w for w in P[pi + 1:] if ev[w] != 0.0]
                newD = []
                for w in D:
                    if ev[w] > 0.0:
                        newP.append(w)
                    elif ev[w] < 0.0:
                        newD.append(w)
                clique.append(v)
                expand(val, clique, newP, newD)
                clique.pop()

    for i in range(nv):
        tv[0] += cv[i]
        if kmax > 1:
            ei = ce[i]
            P = [j for j in range(i + 1, nv) if ei[j] > 0.0]
            D = [j for j in range(i + 1, nv) if ei[j] < 0.0]
            expand(cv[i], [i], P, D)


def _ap_hash_py(b):
    h = 0xAAAAAAAA
    M = 0xFFFFFFFF
    for i, c in enumerate(b):
        if (i & 1) == 0:
            h ^= ((h << 7) ^ (c * (h >> 3))) & M
        else:
            h ^= (~((h << 11) + (c ^ (h >> 5))) & M)
        h &= M
    return h


def ap_hash_batch(strings):
    """uint32[n] of ArashPartov hashes, one per input string (the native
    engine; :func:`_ap_hash_py` is its plain version)."""
    bs = [s.encode("utf-8") for s in strings]
    lib = _load()
    n = len(bs)
    offsets = np.zeros(n + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in bs])
    data = np.frombuffer(b"".join(bs), dtype=np.uint8)
    if data.size == 0:
        data = np.zeros(1, np.uint8)
    data = np.ascontiguousarray(data)
    out = np.zeros(n, np.uint32)
    lib.ap_hash_batch(n, data, offsets, out)
    return out


def _pack_strs(strs):
    bs = [s.encode("utf-8") for s in strs]
    offs = np.zeros(len(bs) + 1, np.int64)
    offs[1:] = np.cumsum([len(b) for b in bs])
    data = np.frombuffer(b"".join(bs) or b"\0", dtype=np.uint8)
    return np.ascontiguousarray(data), offs


def nspd_hash_graph(n, raw_src, raw_dst, esrc, edst, vlabels, elabels,
                    R, D):
    """Native NSPD per-graph engine (src/nspd.cpp): level neighborhoods,
    distance pairs, canonical neighborhood encodings + AP hashes.

    Returns ``(H, pa, pb, pd)`` — ``H`` is ``uint32[(R+1, n)]`` of
    neighborhood hashes, ``(pa, pb, pd)`` the (source, target, level)
    distance triples.
    """
    lib = _load()
    raw_src = np.ascontiguousarray(raw_src, np.int32)
    raw_dst = np.ascontiguousarray(raw_dst, np.int32)
    esrc = np.ascontiguousarray(esrc, np.int32)
    edst = np.ascontiguousarray(edst, np.int32)
    vb, vo = _pack_strs(vlabels)
    eb, eo = _pack_strs(elabels)
    H = np.zeros(max((R + 1) * n, 1), np.uint32)
    cap = n * n + 2 * n + 1
    pa = np.zeros(cap, np.int32)
    pb = np.zeros(cap, np.int32)
    pd = np.zeros(cap, np.int32)
    cnt = lib.nspd_hash_graph(n, R, D, len(raw_src), raw_src, raw_dst,
                              len(esrc), esrc, edst, vb, vo, eb, eo,
                              H, cap, pa, pb, pd)
    if cnt < 0:  # pragma: no cover - capacity bound is provably safe
        raise RuntimeError("nspd_hash_graph capacity exceeded")
    return (H[:(R + 1) * n].reshape(R + 1, n),
            pa[:cnt], pb[:cnt], pd[:cnt])


def canonical_labeling_native(n, src, dst, colors, directed):
    """Canonical vertex positions via the native individualization-
    refinement engine (src/canonical.cpp)."""
    lib = _load()
    if n == 0:
        return np.zeros(0, np.int32)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    colors = np.ascontiguousarray(colors, np.int32)
    ne = len(src)
    if ne == 0:  # ndpointer rejects size-0 views; pass 1-byte dummies
        src = np.zeros(1, np.int32)
        dst = np.zeros(1, np.int32)
    out = np.zeros(n, np.int32)
    rc = lib.canonical_labeling(n, ne, src, dst, colors,
                                1 if directed else 0, out)
    if rc != 0:  # pragma: no cover
        raise RuntimeError("canonical_labeling failed")
    return out


def odd_sth_decompose_native(node_off, adj_off, adj, label_codes,
                             label_ids, h):
    """Native ODD-STh batch decomposition (src/odd_sth.cpp).

    ``node_off`` int64[n_graphs+1] per-graph vertex offsets,
    ``adj_off`` int64[total_nodes+1] CSR offsets, ``adj`` int32 local
    neighbor indices, ``label_codes`` int64 ORDER-PRESERVING per-node
    codes (batch-local, drive the Kahn ordering), ``label_ids`` int64
    stable per-node label identities (mixed into the fingerprints, must
    match across fit/transform), ``h`` the BFS depth cap (-1 =
    unbounded).

    Returns ``(ha, hb, C, node, graph, freq)`` — the distinct-subtree
    fingerprint halves and C weights in first-appearance order plus the
    (table row, graph column, frequency) COO stream.
    """
    lib = _load()
    node_off = np.ascontiguousarray(node_off, np.int64)
    adj_off = np.ascontiguousarray(adj_off, np.int64)
    adj = np.ascontiguousarray(adj, np.int32)
    if adj.size == 0:
        adj = np.zeros(1, np.int32)
    label_codes = np.ascontiguousarray(label_codes, np.int64)
    label_ids = np.ascontiguousarray(label_ids, np.int64)
    n_graphs = len(node_off) - 1
    pha = ctypes.POINTER(ctypes.c_uint64)()
    phb = ctypes.POINTER(ctypes.c_uint64)()
    pC = ctypes.POINTER(ctypes.c_int64)()
    pnode = ctypes.POINTER(ctypes.c_int32)()
    pgraph = ctypes.POINTER(ctypes.c_int32)()
    pfreq = ctypes.POINTER(ctypes.c_int64)()
    nnz = ctypes.c_int64(0)
    rows = lib.odd_sth_decompose(
        n_graphs, node_off, adj_off, adj, label_codes, label_ids, int(h),
        ctypes.byref(pha), ctypes.byref(phb), ctypes.byref(pC),
        ctypes.byref(pnode), ctypes.byref(pgraph), ctypes.byref(pfreq),
        ctypes.byref(nnz))
    try:
        if rows < 0:  # pragma: no cover
            raise RuntimeError("odd_sth_decompose failed")
        m = int(nnz.value)
        D = int(rows)
        ha = np.ctypeslib.as_array(pha, shape=(max(D, 1),))[:D].copy()
        hb = np.ctypeslib.as_array(phb, shape=(max(D, 1),))[:D].copy()
        C = np.ctypeslib.as_array(pC, shape=(max(D, 1),))[:D].copy()
        node = np.ctypeslib.as_array(pnode, shape=(max(m, 1),))[:m].copy()
        graph = np.ctypeslib.as_array(pgraph, shape=(max(m, 1),))[:m].copy()
        freq = np.ctypeslib.as_array(pfreq, shape=(max(m, 1),))[:m].copy()
    finally:
        for p in (pha, phb, pC, pnode, pgraph, pfreq):
            lib.odd_sth_free(p)
    return ha, hb, C, node, graph, freq


def sp_bfs_counts_native(node_off, adj_off, adj, labels, L, D):
    """Unit-weight APSP triplet counts via batched BFS (src/sp_bfs.cpp).

    ``node_off`` int64[n_graphs+1], ``adj_off`` int64[total_nodes+1]
    CSR offsets, ``adj`` int32 local neighbor indices, ``labels`` int32
    label ids in [0, L).  Returns the aggregated COO stream
    ``(gids int32, ids int64, counts int64)`` with the device id
    encoding ``(lu * L + lv) * D + d``.  Raises if any distance reaches
    ``D``."""
    lib = _load()
    node_off = np.ascontiguousarray(node_off, np.int64)
    adj_off = np.ascontiguousarray(adj_off, np.int64)
    adj = np.ascontiguousarray(adj, np.int32)
    if adj.size == 0:
        adj = np.zeros(1, np.int32)
    labels = np.ascontiguousarray(labels, np.int32)
    if labels.size == 0:
        labels = np.zeros(1, np.int32)
    pg = ctypes.POINTER(ctypes.c_int32)()
    pk = ctypes.POINTER(ctypes.c_int64)()
    pc = ctypes.POINTER(ctypes.c_int64)()
    nnz = ctypes.c_int64(0)
    rc = lib.sp_bfs_counts(len(node_off) - 1, node_off, adj_off, adj,
                           labels, int(L), int(D),
                           ctypes.byref(pg), ctypes.byref(pk),
                           ctypes.byref(pc), ctypes.byref(nnz))
    if rc != 0:
        raise ValueError("sp_bfs_counts: distance reached D")
    try:
        m = int(nnz.value)
        gids = np.ctypeslib.as_array(pg, shape=(max(m, 1),))[:m].copy()
        ids = np.ctypeslib.as_array(pk, shape=(max(m, 1),))[:m].copy()
        cnts = np.ctypeslib.as_array(pc, shape=(max(m, 1),))[:m].copy()
    finally:
        for p in (pg, pk, pc):
            lib.sp_bfs_free(p)
    return gids, ids, cnts


def clique_values(cv, ce, kmax):
    """tv[s] = sum over enumerated (s+1)-cliques of
    prod(cv) * prod(|ce|); returns array of length kmax + 1."""
    cv = np.ascontiguousarray(cv, np.float64)
    ce = np.ascontiguousarray(ce, np.float64)
    nv = cv.shape[0]
    tv = np.zeros(kmax + 1, np.float64)
    _load().clique_values(nv, kmax, cv, ce.reshape(-1), tv)
    return tv


def connected_subsets_native(G, k):
    """Native ESU enumeration of connected k-subsets of ``G``
    ({vertex: iterable of neighbors}); returns a set of frozensets of
    the original vertex symbols."""
    lib = _load()
    symbols = list(G.keys())
    index = {s: i for i, s in enumerate(symbols)}
    n = len(symbols)
    offs = np.zeros(n + 1, np.int32)
    adj_l = []
    for i, s in enumerate(symbols):
        nbrs = [index[u] for u in G[s] if u in index and u != s]
        adj_l.extend(nbrs)
        offs[i + 1] = len(adj_l)
    adj = np.asarray(adj_l, np.int32) if adj_l else np.zeros(1, np.int32)
    outp = ctypes.POINTER(ctypes.c_int)()
    cnt = lib.consubg(n, offs, np.ascontiguousarray(adj), int(k),
                      ctypes.byref(outp))
    try:
        if cnt == 0:
            return set()
        flat = np.ctypeslib.as_array(outp, shape=(cnt * int(k),)).copy()
    finally:
        lib.consubg_free(outp)
    rows = flat.reshape(cnt, int(k))
    return {frozenset(symbols[int(v)] for v in row) for row in rows}
