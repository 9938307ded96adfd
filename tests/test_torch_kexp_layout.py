"""The wide-BVH experiment kernel's tables as csrc/kexp_traverse.cu reads
them, and its wrapper's refusals (pbrt_tpu_torch/tools/kexp_kernels.py).

No JAX program runs here: the tree is the port's own build of a
3,000-triangle soup. What is held:

- staged records are unpadded: 128 bytes a wide-4 record, 256 a wide-8 one,
  so 227 KB of shared memory hold 1,816 and 908 of them;
- ``staged_image``, the torch mirror of the kernel's staging copy (chunk c
  of record r in slot r·C + (c ^ r mod 8)), holds exactly the records, and
  for every 8 consecutive records each chunk index falls on 8 different
  16-byte bank groups (slot mod 8), for wide 4 and wide 8;
- every triangle of the leaf-row layouts (variant 1's rows and variant 5's
  dual rows) starts on an 8-byte boundary and its five 8-byte loads stay
  in its 512-byte row;
- the wrapper raises on a block size the kernel does not take, on a staged
  count the tree does not have and on tables that do not start on the
  boundary of the kernel's loads, on every device, and on a device that is
  neither the CPU nor CUDA; it never runs the twin in the kernel's place.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import entry
from pbrt_tpu_torch.ops.bvh import NODE_WORDS
from pbrt_tpu_torch.tools import kexp_kernels as kk
from pbrt_tpu_torch.tools import kexp_prep, kexp_run


@pytest.fixture(scope="module")
def tree():
    """The file arrays of the port's tree over a 3,000-triangle soup."""
    return kexp_prep.tree_arrays(entry._triangle_soup("cpu", n=3000).bvh)


def _layout(tree, wide=4, leaf_max=16, dual=False):
    return kexp_run.layout_of(tree, torch.device("cpu"), wide, leaf_max, dual)


def _rays(n=256, seed=7):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o), torch.as_tensor(d),
            torch.full((n,), 1e30, dtype=torch.float32))


def _numbered(lay, n):
    """``lay`` with n records whose words are 0, 1, 2, ... (so a chunk
    names its record and its place)."""
    words = NODE_WORDS[lay.wide]
    return dataclasses.replace(lay, nodes=torch.arange(
        n * words, dtype=torch.float32).reshape(n, words))


@pytest.mark.parametrize("wide,leaf_max,rec_bytes,n_fit",
                         [(4, 16, 128, 1816), (8, 8, 256, 908)])
def test_staged_records_are_unpadded(tree, wide, leaf_max, rec_bytes, n_fit):
    lay = _layout(tree, wide, leaf_max)
    assert kk.node_smem_bytes(lay, 10) == 10 * rec_bytes
    assert kk.max_smem_nodes(lay, 227) == min(lay.n_nodes, n_fit)
    big = _numbered(lay, 5000)
    assert kk.max_smem_nodes(big, 227) == n_fit
    assert (kk.node_smem_bytes(big, n_fit) <= 227 * 1024
            < kk.node_smem_bytes(big, n_fit + 1))
    # the bytes asked for are the staged image's, nothing more
    assert (kk.staged_image(big, n_fit).numel() * 4
            == kk.node_smem_bytes(big, n_fit))


@pytest.mark.parametrize("wide,leaf_max", [(4, 16), (8, 8)])
def test_staged_image_unswizzles_to_the_records(tree, wide, leaf_max):
    lay = _numbered(_layout(tree, wide, leaf_max), 37)
    C = NODE_WORDS[wide] // 4
    img = kk.staged_image(lay, 37)
    assert img.shape == (37 * C, 4) and img.dtype == torch.float32
    chunks = lay.nodes.reshape(37, C, 4)
    for r in range(37):
        for c in range(C):
            assert torch.equal(img[r * C + (c ^ (r % 8))], chunks[r, c])
    # nothing else: the image is the records' chunks permuted
    assert torch.equal(img[:, 0].sort().values, chunks[..., 0].reshape(-1))
    assert torch.equal(kk.staged_image(lay, 5), img[:5 * C])


@pytest.mark.parametrize("wide,leaf_max", [(4, 16), (8, 8)])
def test_swizzle_spreads_a_phase_over_eight_bank_groups(tree, wide, leaf_max):
    n = 64
    lay = _numbered(_layout(tree, wide, leaf_max), n)
    C = NODE_WORDS[wide] // 4
    img = kk.staged_image(lay, n)
    # slot of chunk (r, c), from the word each chunk starts with
    slot = torch.empty(n * C, dtype=torch.long)
    slot[(img[:, 0] / 4).long()] = torch.arange(n * C)
    slot = slot.reshape(n, C)
    for first in range(n - 7):
        for c in range(C):
            groups = (slot[first:first + 8, c] % 8).tolist()
            assert sorted(groups) == list(range(8)), (first, c, groups)
    # unswizzled and unpadded, chunk c of 8 records is one bank group
    assert {(r * C + 3) % 8 for r in range(8)} == {3}


@pytest.mark.parametrize("dual", [False, True])
def test_leaf_row_triangles_start_on_8_byte_boundaries(tree, dual):
    lay = _layout(tree, dual=dual)
    base = 5 if dual else 1
    W, mask = lay.wide, (1 << lay.cnt_bits) - 1
    enc = lay.nodes[:, 6 * W:7 * W].contiguous().view(torch.int32).reshape(-1)
    leaf = enc[(enc >= 0) & ((enc & mask) > 0)].long()
    target, cnt = leaf >> lay.cnt_bits, leaf & mask
    assert int(cnt.max()) > 12          # leaves that take a second row
    if dual:
        assert int(cnt.min()) <= 8      # and leaves of one row
    addr = kk._row_addr(lay, base, target, cnt)
    real = torch.arange(addr.shape[1])[None, :] < cnt[:, None]
    byte = addr[real] * 4
    assert len(byte) == int(cnt.sum())
    assert bool((byte % 8 == 0).all())
    # the five 8-byte loads of a triangle stay in its 512-byte row
    assert bool((byte % 512 + 40 <= 512).all())
    assert lay.rows.shape[1] * 4 == 512 and lay.rows.data_ptr() % 8 == 0
    # and read the triangle: the index field names a leaf slot
    idx = lay.rows.reshape(-1)[addr[real] + 9]
    assert bool((idx >= 0).all()) and len(idx.unique()) == len(idx)


def _shifted(x, nbytes):
    """A copy of x whose data starts ``nbytes`` past an aligned address."""
    buf = torch.zeros(x.numel() + 4, dtype=x.dtype)
    out = buf[nbytes // 4:nbytes // 4 + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == nbytes
    return out


def test_wrapper_raises_and_never_falls_back(tree):
    lay = _layout(tree)
    o, d, tmax = _rays()
    before = kk.traverse.launches, kk.traverse.last_threads
    want = kk._traverse_wide_reference(lay, o, d, tmax, any_hit=False,
                                       variant=2)
    for smem in (0, 3, lay.n_nodes):    # the CPU runs the twin, staged or not
        got = kk.traverse(lay, o, d, tmax, any_hit=False, variant=2,
                          smem_nodes=smem)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (32, 100, 512, 1024):
        with pytest.raises(ValueError, match="block"):
            kk.traverse(lay, o, d, tmax, any_hit=False, variant=2, block=bad)
    for bad in (-1, lay.n_nodes + 1):
        with pytest.raises(ValueError, match="smem_nodes"):
            kk.traverse(lay, o, d, tmax, any_hit=False, variant=2,
                        smem_nodes=bad)
    # triangle records are read in 16-byte loads, leaf rows in 8-byte ones
    recs4 = dataclasses.replace(lay, recs=_shifted(lay.recs, 4))
    with pytest.raises(ValueError, match="leaf table.*16-byte"):
        kk.traverse(recs4, o, d, tmax, any_hit=False, variant=2)
    with pytest.raises(ValueError, match="leaf table.*16-byte"):
        kk.traverse(dataclasses.replace(lay, recs=_shifted(lay.recs, 8)),
                    o, d, tmax, any_hit=True, variant=3)
    want1 = kk.traverse(lay, o, d, tmax, any_hit=False, variant=1)
    got1 = kk.traverse(recs4, o, d, tmax, any_hit=False, variant=1)
    assert all(torch.equal(a, b) for a, b in zip(got1, want1))
    with pytest.raises(ValueError, match="leaf table.*8-byte"):
        kk.traverse(dataclasses.replace(lay, rows=_shifted(lay.rows, 4)),
                    o, d, tmax, any_hit=False, variant=1)
    rows8 = dataclasses.replace(lay, rows=_shifted(lay.rows, 8))
    got8 = kk.traverse(rows8, o, d, tmax, any_hit=False, variant=1)
    assert all(torch.equal(a, b) for a, b in zip(got8, want1))
    with pytest.raises(ValueError, match="nodes.*16-byte"):
        kk.traverse(dataclasses.replace(lay, nodes=_shifted(lay.nodes, 8)),
                    o, d, tmax, any_hit=False, variant=2)
    # neither the CPU nor CUDA: no plain version in the kernel's place
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(NotImplementedError):
        kk.traverse(lay, meta, meta, meta[:, 0], any_hit=False, variant=2)
    assert (kk.traverse.launches, kk.traverse.last_threads) == before
