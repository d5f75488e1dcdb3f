"""PyTorch port of the lane permutes (kernel K2): the plain versions vs the
JAX ``permute_pallas`` kernels in interpret mode, bitwise; and the CUDA
source's gather and scatter bodies, built as host C++ and run over the
kernels' grid, vs the plain versions, bitwise."""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srbd_nmpc_tpu.ops import permute_pallas as pp
from srbd_nmpc_tpu_torch.ops import permute
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield
    monkeypatch.undo()


def _sorted_idx(rng, B, Bc, clumpy=False):
    if clumpy:
        p = np.ones(B)
        p[: B // 3] = 8.0
        p[-B // 5:] = 0.05
        p /= p.sum()
        return np.sort(rng.choice(B, size=Bc, replace=False, p=p))
    return np.sort(rng.choice(B, size=Bc, replace=False))


@pytest.mark.parametrize("clumpy", [False, True])
def test_take_lanes_bitwise_vs_jax_kernel(interpret_pallas, clumpy):
    rng = np.random.default_rng(3 + clumpy)
    B, Bc = 4096, 1024
    a = rng.normal(size=(5, 12, B)).astype(np.float32)
    idx = _sorted_idx(rng, B, Bc, clumpy)
    ref = pp.take_lanes(jnp.asarray(a), jnp.asarray(idx, jnp.int32),
                        window=8, force=True)
    before = dict(permute.launches)
    got = permute.take_lanes(torch.as_tensor(a), torch.as_tensor(idx))
    assert permute.launches == before   # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("clumpy", [False, True])
def test_set_lanes_bitwise_vs_jax_kernel(interpret_pallas, clumpy):
    rng = np.random.default_rng(17 + clumpy)
    B, Bc = 4096, 1024
    orig = rng.normal(size=(5, 12, B)).astype(np.float32)
    src = rng.normal(size=(5, 12, Bc)).astype(np.float32)
    idx = _sorted_idx(rng, B, Bc, clumpy)
    ref = pp.set_lanes(jnp.asarray(orig), jnp.asarray(src),
                       jnp.asarray(idx, jnp.int32), force=True)
    o = torch.as_tensor(orig)
    got = permute.set_lanes(o, torch.as_tensor(src), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(o.numpy(), orig)   # input left untouched


@pytest.fixture(scope="module")
def host_k2():
    """``csrc/permute.cu``'s per-thread bodies built as host C++ (g++),
    run over an emulated grid: ``take(a, idx, rpb, vec, threads)`` and
    ``set(orig, src, idx, rpb, vec, threads)`` on numpy arrays, through
    the 4-byte entries for float32 data and the 8-byte ones for float64."""
    lib = ctypes.CDLL(build.build_host(f"{build.CSRC}/permute.cu"))
    fns = {}
    for size, tag in ((4, ""), (8, "8")):
        take = getattr(lib, f"srbd_take_lanes{tag}_host")
        put = getattr(lib, f"srbd_set_lanes{tag}_host")
        take.argtypes = ([ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.c_void_p]
                         + [ctypes.c_int64] * 4 + [ctypes.c_int] * 2)
        put.argtypes = ([ctypes.c_void_p] * 3
                        + [ctypes.c_int, ctypes.c_void_p]
                        + [ctypes.c_int64] * 4 + [ctypes.c_int] * 2)
        take.restype = put.restype = ctypes.c_int
        fns[size] = (take, put)

    def run_take(a, idx, rpb, vec, threads):
        B, Bc = a.shape[-1], idx.shape[0]
        R = a.size // B
        out = np.full(a.shape[:-1] + (Bc,), np.nan, a.dtype)
        assert fns[a.itemsize][0](a.ctypes.data, idx.ctypes.data,
                                  idx.itemsize, out.ctypes.data, R, B, Bc,
                                  rpb, vec, threads) == 0
        return out

    def run_set(orig, src, idx, rpb, vec, threads):
        B, Bc = orig.shape[-1], idx.shape[0]
        R = orig.size // B
        out = np.full_like(orig, np.nan)
        assert fns[orig.itemsize][1](orig.ctypes.data, src.ctypes.data,
                                     idx.ctypes.data, idx.itemsize,
                                     out.ctypes.data, R, B, Bc, rpb, vec,
                                     threads) == 0
        return out

    return run_take, run_set


# -0, infinities and NaNs with payloads, by element type
SPECIAL = {
    np.float32: (np.uint32, [0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001,
                             0xFFBADBAD, 0x7F812345]),
    np.float64: (np.uint64, [0x8000000000000000, 0x7FF0000000000000,
                             0xFFF0000000000000, 0x7FF8000000000001,
                             0xFFFBADBADBADBAD5, 0x7FF0123456789ABC]),
}


def _words(rng, shape, dtype=np.float32):
    """float32 (or float64) data with -0, infinities and NaNs with
    payloads among it."""
    bits, special = SPECIAL[dtype]
    a = rng.normal(size=shape).astype(dtype)
    flat = a.reshape(-1).view(bits)
    special = np.array(special, bits)
    pos = rng.choice(flat.size, size=min(flat.size, 4 * special.size),
                     replace=False)
    flat[pos] = np.resize(special, pos.size)
    return a


# (shape, Bc, pattern): phase 3's bitwise cases at small sizes
HOST_CASES = [
    ((5, 12, 2048), 1024, "uniform"),
    ((5, 12, 2048), 64, "uniform"),
    ((5, 12, 2048), 1024, "clumpy"),
    ((5, 12, 2048), 512, "dense"),
    ((5, 12, 2048), 2048, "all"),
    ((12, 2048), 1024, "uniform"),
    ((7, 500), 77, "uniform"),
    ((3, 12, 4099), 1031, "clumpy"),
    ((1, 1000), 250, "uniform"),
    ((9, 64), 0, "uniform"),
]


def _case_idx(rng, B, Bc, pattern):
    if pattern == "dense":
        return np.arange(Bc)
    if pattern == "all":
        return np.arange(B)
    return _sorted_idx(rng, B, Bc, pattern == "clumpy")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape,Bc,pattern", HOST_CASES)
def test_host_build_bitwise_vs_plain(host_k2, shape, Bc, pattern, idx_dtype,
                                     dtype):
    """The CUDA source's gather and scatter bodies, built as host C++ and
    run over the kernels' grid (the wrapper's rows per block at 132 SMs,
    and 1 and 3 rows at 32 threads), bitwise equal to the plain versions,
    on float32 data (4-byte words) and float64 data (the 8-byte form); the
    vector path wherever the width allows it."""
    run_take, run_set = host_k2
    rng = np.random.default_rng(shape[-1] + 7 * Bc + len(pattern))
    B = shape[-1]
    bits = SPECIAL[dtype][0]
    a = _words(rng, shape, dtype)
    src = _words(rng, shape[:-1] + (Bc,), dtype)
    idx = _case_idx(rng, B, Bc, pattern).astype(idx_dtype)
    ti = torch.as_tensor(idx.astype(np.int64))
    ref_t = permute.take_lanes_ref(torch.as_tensor(a), ti).numpy()
    ref_s = permute.set_lanes_ref(torch.as_tensor(a), torch.as_tensor(src),
                                  ti).numpy()
    R = a.size // B
    geoms = [(permute.rows_per_block(R, n, 132), permute.THREADS)
             for n in (Bc, B)] + [(1, 32), (3, 32)]
    for (rpb_t, threads), (rpb_s, _) in zip(geoms, geoms[1:] + geoms[:1]):
        for vec in {0, int(Bc % 4 == 0)}:
            if Bc:
                got = run_take(a, idx, rpb_t, vec, threads)
                np.testing.assert_array_equal(got.view(bits),
                                              ref_t.view(bits))
        for vec in {0, int(B % 4 == 0)}:
            got = run_set(a, src, idx, rpb_s, vec, threads)
            np.testing.assert_array_equal(got.view(bits), ref_s.view(bits))


@pytest.mark.parametrize("R,lanes", [(252, 65536), (240, 16384), (12, 4096),
                                     (252, 131072), (1, 77), (200000, 8)])
def test_rows_per_block_fills_the_card(R, lanes):
    rpb = permute.rows_per_block(R, lanes, 132)
    nx = -(-lanes // (permute.LANES * permute.THREADS))
    ny = -(-R // rpb)
    assert 1 <= rpb <= max(R, 1) and ny <= permute.MAX_ROW_BLOCKS
    # about BLOCKS_PER_SM blocks per SM, or one row per block
    assert rpb == 1 or nx * ny >= permute.BLOCKS_PER_SM * 132 // 2
    assert nx * ny <= 2 * permute.BLOCKS_PER_SM * 132 or rpb == 1


def test_dense_prefix_and_any_width():
    # compaction's common case (idx = 0..Bc-1) and widths the TPU kernels
    # could not take (not multiples of 256)
    rng = np.random.default_rng(23)
    for B, Bc in ((2048, 512), (500, 77)):
        orig = torch.as_tensor(rng.normal(size=(7, B)))
        src = torch.as_tensor(rng.normal(size=(7, Bc)))
        idx = torch.as_tensor(np.sort(rng.choice(B, Bc, replace=False)))
        for ix in (torch.arange(Bc), idx):
            out = permute.set_lanes(orig, src, ix)
            ref = orig.clone()
            ref[:, ix] = src
            assert torch.equal(out, ref)
            assert torch.equal(permute.take_lanes(out, ix), src)
