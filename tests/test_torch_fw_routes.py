"""K3's route choice and the order of its integral-weight route, on the
CPU: ``fw_route`` and ``fw_tile_config`` at their boundaries, a torch
emulation of the blocked three-phase order (a helper of this file, not
of the package) bit for bit against ``floyd_warshall_plain`` and the JAX
``batched_floyd_warshall`` on integer weights, and ShortestPath's
``integral`` flag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grakel_torch
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset
from grakel_torch.kernels import shortest_path as sp_mod
from grakel_torch.ops import floyd_warshall as fw
from grakel_tpu.ops.floyd_warshall import batched_floyd_warshall as jax_fw


@pytest.mark.parametrize("integral", [False, True])
@pytest.mark.parametrize("V", [1, 32, 33, 64, 65, 128, 129])
def test_fw_route_boundaries(V, integral):
    want = "tile" if V <= fw.ROUTE_A_MAX_V else (
        "blocked" if integral else "per_k")
    assert fw.fw_route(V, integral) == want


@pytest.mark.parametrize("n", [1, 5, 1000])
@pytest.mark.parametrize("V,T", [
    (1, 2), (7, 2), (24, 2), (25, 4), (31, 4), (32, 4), (33, 4), (63, 4),
    (64, 4), (65, 8), (127, 8), (128, 8)])
def test_fw_tile_config_boundaries(V, T, n):
    """Each V takes its instantiation's tile width; a block holds 1..n
    graphs, as many as fit in 128 threads (one when a graph needs
    more), and never more threads than the instantiation's launch
    bound."""
    got_T, G = fw.fw_tile_config(n, V)
    tpg = (-(-V // T)) ** 2
    assert got_T == T
    assert 1 <= G <= n and G * tpg <= fw.TILE_MAX_THREADS[T]
    assert G * tpg <= max(128, tpg)
    assert G == n or (G + 1) * tpg > 128


def _init(A, M):
    """floyd_warshall_plain's initialisation."""
    V = A.shape[1]
    inf = torch.tensor(fw.INF)
    eye = torch.eye(V, dtype=torch.bool)
    S = torch.where(A > 0, A, inf)
    S = torch.where(eye[None], 0.0, S)
    S = torch.where(M[:, :, None] & M[:, None, :], S, inf)
    return torch.where(eye[None] & M[:, :, None], 0.0, S)


def blocked_fw(A, M, tile):
    """APSP in the order of K3's route "blocked": rounds over the pivot
    tiles r; in each, the pivot tile with k in order, then the pivot
    row's and column's tiles with k in order, then every other tile as
    the min over the pivot's k of column-panel + row-panel sums.  The
    batch is padded to whole tiles with INF."""
    n, V = A.shape[:2]
    nt = -(-V // tile)
    Vp = nt * tile
    S = torch.full((n, Vp, Vp), fw.INF)
    S[:, :V, :V] = _init(A, M)
    for r in range(nt):
        p = slice(r * tile, (r + 1) * tile)
        ks = range(r * tile, (r + 1) * tile)
        for k in ks:   # phase 1
            S[:, p, p] = torch.minimum(S[:, p, p],
                                       S[:, p, k, None] + S[:, None, k, p])
        for k in ks:   # phase 2 (on the pivot tile a no-op)
            S[:, p, :] = torch.minimum(S[:, p, :],
                                       S[:, p, k, None] + S[:, None, k, :])
            S[:, :, p] = torch.minimum(S[:, :, p],
                                       S[:, :, k, None] + S[:, None, k, p])
        via = (S[:, :, p, None] + S[:, None, p, :]).amin(2)   # phase 3
        off = torch.ones(Vp, dtype=torch.bool)
        off[p] = False
        rest = off[:, None] & off[None, :]
        S = torch.where(rest[None], torch.minimum(S, via), S)
    return S[:, :V, :V]


def _int_batch(seed, n, V, wmax, prefix):
    rng = np.random.RandomState(seed)
    A = (rng.rand(n, V, V) < 3.0 / V).astype(np.float32)
    A *= rng.randint(1, wmax + 1, (n, V, V)).astype(np.float32)
    A = np.triu(A, 1)
    A = A + A.transpose(0, 2, 1)
    if prefix:
        M = np.zeros((n, V), bool)
        for g in range(n):
            M[g, :rng.randint(1, V + 1)] = True
    else:
        M = rng.rand(n, V) < 0.8
    A[~(M[:, :, None] & M[:, None, :])] = rng.randint(0, 3)   # junk
    return A, M


@pytest.mark.parametrize("V,tile,wmax,prefix", [
    (130, 32, 1, True), (130, 64, 4, False), (200, 32, 4, True),
    (200, 64, 1, False), (33, 32, 7, False), (129, 32, 3, True)])
def test_blocked_order_bit_identical_on_integer_weights(V, tile, wmax,
                                                        prefix):
    """On integer weights the blocked order gives the sequential order's
    bits: every finite sum is exact and INF + w rounds back to INF."""
    A, M = _int_batch(V * 7 + tile + wmax, 3, V, wmax, prefix)
    got = blocked_fw(torch.from_numpy(A), torch.from_numpy(M), tile)
    ref = fw.floyd_warshall_plain(torch.from_numpy(A), torch.from_numpy(M))
    jref = np.asarray(jax_fw(jnp.asarray(A), jnp.asarray(M)))
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert np.array_equal(got.numpy().view(np.uint32), jref.view(np.uint32))
    finite = ref < fw.INF
    assert finite.any() and (~finite).any()
    assert torch.equal(ref[finite], ref[finite].round())


def test_blocked_order_reassociates_float_weights():
    """Why the blocked route needs integral weights: on f32 weights its
    order changes the last bits of some distances (the hash route keys
    on them)."""
    rng = np.random.RandomState(0)
    A = (rng.rand(3, 130, 130) < 0.05).astype(np.float32)
    A *= rng.uniform(0.5, 2.0, A.shape).astype(np.float32)
    A = torch.from_numpy(np.triu(A, 1) + np.triu(A, 1).transpose(0, 2, 1))
    M = torch.ones((3, 130), dtype=torch.bool)
    got = blocked_fw(A, M, 32)
    ref = fw.floyd_warshall_plain(A, M)
    assert not torch.equal(got.view(torch.int32), ref.view(torch.int32))
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)


def test_integral_flag_changes_nothing_on_cpu():
    rng = np.random.RandomState(3)
    A = (rng.rand(4, 140, 140) < 0.03).astype(np.float32)
    A *= rng.uniform(0.5, 2.0, A.shape).astype(np.float32)
    M = torch.from_numpy(rng.rand(4, 140) < 0.9)
    A = torch.from_numpy(A)
    ref = fw.floyd_warshall_plain(A, M)
    for integral in (False, True):
        got = fw.batched_floyd_warshall(A, M, integral=integral)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    with pytest.raises(ValueError):
        fw.floyd_warshall_cuda(A, M, integral=True)


@pytest.mark.parametrize("weighted,with_labels", [
    (False, True), (False, False), (True, True)])
def test_shortest_path_passes_integral(monkeypatch, weighted, with_labels):
    """ShortestPath promises integral weights exactly when every edge
    weight is 1 (its parse's ``unit`` flag)."""
    seen = []
    real = sp_mod.batched_floyd_warshall

    def spy(adj, node_mask, integral=False):
        seen.append(integral)
        return real(adj, node_mask, integral=integral)

    monkeypatch.setattr(sp_mod, "batched_floyd_warshall", spy)
    train, test = generate_dataset(
        n_graphs=30, n_graphs_test=6, r_vertices=(3, 20),
        r_connectivity=(0.1, 0.4), random_state=11,
        r_weight_edges=(0.5, 2.0) if weighted else (1, 1),
        features=("nl", 4))
    with use_device("cpu"):
        k = grakel_torch.ShortestPath(with_labels=with_labels)
        k.fit_transform(train)
        k.transform(test)
    assert seen and all(f == (not weighted) for f in seen)
