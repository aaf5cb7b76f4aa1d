"""Decode under the reference's layout, on one process: the pieces of
context-parallel decoding held against the whole cache.

- ``model_parallel.local_cache``: for every arch at published size (meta
  tensors), on the abstract production meshes, under the default rules
  and the dry run's decode and long-context rules, each leaf is the block
  ``cache_specs`` gives it (each dimension over the product of its axes'
  sizes) and the whole shape is recorded; qwen2-vl-2b's ``decode_32k``
  cache on 16 x 16 is 477,102,080 bytes a rank, 1/256 of the whole.
- ``layers.block_rows`` / ``write_rows`` / ``valid_rows``: writes of S
  rows into P simulated blocks (across a block's end, longer than a
  block, clamped at the end) leave the blocks equal to the whole cache
  written by ``cache_rows``, and the blocks' validity masks are the whole
  mask's.
- The log-sum-exp combine: the merged partials of simulated blocks
  (``decode_partials``, ``merge_partials``), one of them with no valid
  position, equal the port's and the reference's ``_sdpa_decode`` on the
  whole cache, and, with no mask, ``_sdpa``; MLA's absorbed form
  (``mla_partials`` with ``w_uk`` folded into the queries and ``w_uv``
  applied to the merged latents) equals the up-projected keys and values
  of ``mla_attention``.

Tolerances: the reference's fp32 rtol 2e-4 / atol 2e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch import configs as tconfigs
from repro_torch import models as TM
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.ctx import AbstractMesh
from repro_torch.distributed.model_parallel import (LocalCache, Split,
                                                    local_cache)
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import specs as tspecs
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-4, atol=2e-5)
MESHES = {"16x16": AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
RULES = ("default", "decode_32k", "long_500k")


def _rules(arch, name):
    return {} if name == "default" else tdryrun.rules_for(arch, name)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _block(shape, spec, mesh) -> tuple:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for n, axes in zip(shape, spec):
        for a in (() if axes is None else (axes,) if isinstance(axes, str)
                  else axes):
            n //= sizes[a]
        out.append(n)
    return tuple(out)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_local_cache_leaves_are_the_specs_blocks(arch, rules):
    cfg = tconfigs.get_config(arch)
    B, max_len = 32, 1024
    cache = TM.init_cache(cfg, B, max_len, torch.bfloat16, device="meta")
    for mesh in MESHES.values():
        r = _rules(arch, rules)
        local = local_cache(cache, mesh, r, device="meta")
        assert isinstance(local, LocalCache)
        specs = dict(_leaves(tsharding.cache_specs(cache, mesh, r)))
        whole = dict(_leaves(cache))
        for path, t in _leaves(local):
            pl = local.placements[path]
            assert pl.shape == tuple(whole[path].shape), path
            assert pl.spec == specs[path].spec, path
            assert tuple(t.shape) == _block(pl.shape, pl.spec, mesh), path
            assert t.dtype == whole[path].dtype
            if path[-1] == "index":
                assert tuple(t.shape) == tuple(whole[path].shape)
        assert local.copy().placements is local.placements


def test_qwen2_vl_decode_cache_is_a_256th_a_rank():
    """The dry run's qwen2-vl-2b ``decode_32k`` cell on 16 x 16: B 128
    over the data axis and 33,280 positions over the model axis."""
    cfg = tconfigs.get_config("qwen2-vl-2b")
    _, cache, _ = tspecs.decode_inputs_for(cfg, "decode_32k")
    local = local_cache(cache, MESHES["16x16"],
                        tdryrun.rules_for("qwen2-vl-2b", "decode_32k"),
                        device="meta")
    kv = sum(t.numel() * t.element_size() for p, t in _leaves(local)
             if p[-1] != "index")
    whole = sum(t.numel() * t.element_size() for p, t in _leaves(cache)
                if p[-1] != "index")
    assert whole == 122_138_132_480
    assert kv == 477_102_080 == whole // 256


def _splits(P):
    return [Split(None, P, i, ("model",)) for i in range(P)]


@pytest.mark.parametrize("P,n,writes", [
    (2, 8, [(0, 6), (6, 4), (10, 3)]),           # across a block's end
    (2, 8, [(0, 10), (10, 3), (13, 5)]),         # longer than a block; clamp
    (4, 4, [(0, 1), (1, 9), (10, 6), (16, 3)]),  # several blocks; clamp
    (3, 5, [(0, 15), (15, 2)]),                  # the whole cache; clamp
])
def test_block_writes_equal_the_whole_caches(P, n, writes):
    g = torch.Generator().manual_seed(0)
    B, H, hd = 2, 3, 4
    whole = torch.randn(B, P * n, H, hd, generator=g)
    blocks = list(whole.split(n, dim=1))
    blocks = [b.clone() for b in blocks]
    for idx, S in writes:
        index = torch.tensor(idx, dtype=torch.int32)
        new = torch.randn(B, S, H, hd, generator=g)
        whole.index_copy_(1, TL.cache_rows(index, S, P * n), new)
        valid = torch.arange(P * n) < idx + S
        for sp, blk in zip(_splits(P), blocks):
            rows, inside = TL.block_rows(index, S, n, sp)
            TL.write_rows(blk, rows, inside, new)
            np.testing.assert_array_equal(
                TL.valid_rows(index, S, n, sp).numpy(),
                valid[sp.index * n:(sp.index + 1) * n].numpy())
        torch.testing.assert_close(torch.cat(blocks, dim=1), whole,
                                   rtol=0, atol=0)


def _merge(parts):
    return TL.merge_partials(torch.stack([TL.pack_partials(*p)
                                          for p in parts]))


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("Sq", [1, 3])
def test_combined_blocks_equal_sdpa_decode(P, Sq):
    """Blocks of 3 positions, the first 5 valid: with P = 3 or 4 the last
    blocks hold no valid position, and weigh nothing."""
    rng = np.random.default_rng(P * 10 + Sq)
    B, Hq, Hkv, hd, n = 2, 4, 2, 8, 3
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, P * n, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, P * n, Hkv, hd)).astype(np.float32)
    valid = np.arange(P * n) < 5
    tq, tk, tv, tvalid = map(torch.from_numpy, (q, k, v, valid))
    got = _merge([TL.decode_partials(tq, tk[:, i * n:(i + 1) * n],
                                     tv[:, i * n:(i + 1) * n],
                                     tvalid[i * n:(i + 1) * n])
                  for i in range(P)]).reshape(B, Sq, Hq * hd)
    assert torch.isfinite(got).all()
    want = TL._sdpa_decode(tq, tk, tv, tvalid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    ref = np.asarray(JL._sdpa_decode(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(valid)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # every position valid (the cross-attention's frames): _sdpa
    got = _merge([TL.decode_partials(tq, tk[:, i * n:(i + 1) * n],
                                     tv[:, i * n:(i + 1) * n])
                  for i in range(P)]).reshape(B, Sq, Hq * hd)
    np.testing.assert_allclose(
        got.numpy(), TL._sdpa(tq, tk, tv, causal=False).numpy(), **TOL)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_absorbed_mla_blocks_equal_the_up_projected_cache(P):
    """``w_uk`` folded into the queries, the blocks' latent partials
    merged, then ``w_uv``: the scores and values of the up-projected
    keys and values of ``mla_attention``, over a cache whose last block
    is empty (P = 4)."""
    cfg = tconfigs.reduce_config(tconfigs.get_config("deepseek-v2-lite-16b"))
    r, H, dn, dr, dv = cfg.kv_lora_rank, cfg.n_heads, cfg.qk_nope_dim, \
        cfg.qk_rope_dim, cfg.v_head_dim
    g = torch.Generator().manual_seed(P)
    B, S, n = 2, 2, 4
    c_kv = torch.randn(B, P * n, r, generator=g)
    k_rope = torch.randn(B, P * n, dr, generator=g)
    q_nope = torch.randn(B, S, H, dn, generator=g)
    q_rope = torch.randn(B, S, H, dr, generator=g)
    w_uk = torch.randn(r, H * dn, generator=g) / math.sqrt(r)
    w_uv = torch.randn(r, H * dv, generator=g) / math.sqrt(r)
    valid = torch.arange(P * n) < max(1, (P * n * 2) // 3)
    scale = 1.0 / math.sqrt(dn + dr)
    # mla_attention's form: the cache up-projected to keys and values
    k_nope = (c_kv @ w_uk).reshape(B, -1, H, dn)
    v = (c_kv @ w_uv).reshape(B, -1, H, dv)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) * scale
    logits = logits.masked_fill(~valid[None, None, None], -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    # the absorbed form over P blocks
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk.view(r, H, dn))
    lat = _merge([TL.mla_partials(q_lat, q_rope, c_kv[:, i * n:(i + 1) * n],
                                  k_rope[:, i * n:(i + 1) * n],
                                  valid[i * n:(i + 1) * n], scale)
                  for i in range(P)])
    got = torch.einsum("bqhr,rhd->bqhd", lat, w_uv.view(r, H, dv))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_decode_rows_refuses_a_batch_that_is_not_the_caches():
    from repro_torch.distributed.model_parallel import decode_rows
    cfg = tconfigs.reduce_config(tconfigs.get_config("qwen3-4b"))
    cache = TM.init_cache(cfg, 8, 16, torch.float32, device="meta")
    local = local_cache(cache, MESHES["16x16"], {}, device="meta")
    assert decode_rows(cache) is None
    with pytest.raises(ValueError, match="whole batch"):
        decode_rows(local, 4)
