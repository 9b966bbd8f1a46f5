"""grakel_torch's CUDA kernels on a card: each against its plain PyTorch
version, the wrappers' input checks and launch counts, and the kernels
through the public entry points against the same calls on the CPU.

Every test here needs an NVIDIA card and skips without one; on a
machine with a card run ``python -m pytest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import grakel_torch
from grakel_torch import use_device
from grakel_torch.datasets import generate_dataset
from grakel_torch.kernels.base import normalize_input
from grakel_torch.ops import intersect, wl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,L,integer", [
    (1, 1, 1, True), (64, 64, 32, True), (65, 130, 33, True),
    (300, 257, 1000, True), (37, 1001, 333, False), (5, 3, 0, True)])
def test_min_gram_kernel_matches_plain(cuda, n, m, L, integer):
    rng = np.random.RandomState(n + m + L)
    A = rng.randint(0, 9, (n, L)) if integer else rng.rand(n, L)
    B = rng.randint(0, 9, (m, L)) if integer else rng.rand(m, L)
    A = torch.tensor(A, dtype=torch.float32, device=cuda)
    B = torch.tensor(B, dtype=torch.float32, device=cuda)
    before = intersect.min_gram_cuda.launches
    K = intersect.min_intersection_gram(A, B)
    torch.cuda.synchronize()
    assert intersect.min_gram_cuda.launches == before + 1
    R = intersect.min_gram_plain(A, B)
    if integer:
        assert torch.equal(K, R)
    else:
        torch.testing.assert_close(K, R, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_wl_hash_kernel_bit_identical(cuda, seed):
    rng = np.random.RandomState(seed)
    n, e = 5000, 20000
    args = [torch.tensor(rng.randint(0, 2 ** 31 - 1, n), dtype=torch.int32),
            torch.tensor(rng.randint(0, n, e), dtype=torch.int32),
            torch.tensor(rng.randint(0, n, e), dtype=torch.int32),
            torch.tensor(rng.rand(e) < 0.7)]
    before = wl.wl_hash_refine_cuda.launches
    h = wl.wl_hash_refine(*[a.to(cuda) for a in args])
    assert wl.wl_hash_refine_cuda.launches == before + 1
    p = wl.wl_hash_refine_plain(*args)
    assert torch.equal(h[0].cpu(), p[0]) and torch.equal(h[1].cpu(), p[1])


def test_wrappers_check_inputs(cuda):
    A = torch.ones((4, 6), device=cuda)
    with pytest.raises(ValueError):
        intersect.min_gram_cuda(A.t(), A.t())          # not contiguous
    with pytest.raises(ValueError):
        intersect.min_gram_cuda(A.double(), A)          # wrong dtype
    with pytest.raises(ValueError):
        intersect.min_gram_cuda(A, torch.ones((4, 5), device=cuda))
    i = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        wl.wl_hash_refine_cuda(i.long(), i, i, i.bool())
    with pytest.raises(ValueError):
        wl.wl_hash_refine_cuda(i, i, i.cpu(), i.bool())
    with pytest.raises(ValueError):
        wl.wl_hash_refine_cuda(i, i, i + 4, i.bool())   # endpoint == N


@pytest.mark.parametrize("name,kw", [
    ("WeisfeilerLehman", {"n_iter": 3}),
    ("WeisfeilerLehman", {"n_iter": 5, "normalize": True}),
    ("VertexHistogram", {}),
    ("PyramidMatch", {}), ("PyramidMatch", {"with_labels": False})])
def test_entry_points_on_card_match_cpu(cuda, name, kw):
    train, test = generate_dataset(n_graphs=80, n_graphs_test=10,
                                   r_vertices=(5, 30), random_state=2,
                                   features=("nl", 6))
    # the same Graph objects on both sides: PyramidMatch caches each
    # graph's embedding in it, so both runs histogram the same vectors
    train, test = normalize_input(train), normalize_input(test)
    k = getattr(grakel_torch, name)(**kw)
    K, T = k.fit_transform(train), k.transform(test)
    with use_device("cpu"):
        kc = getattr(grakel_torch, name)(**kw)
        Kc, Tc = kc.fit_transform(train), kc.transform(test)
    assert np.array_equal(K, Kc) and np.array_equal(T, Tc)
