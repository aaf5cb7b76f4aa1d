"""``repro_torch.launch.specs`` against ``repro.launch.specs``.

For every arch of ``ARCH_IDS`` and every shape of ``SHAPES``: the cell
table, the batch, decode-cache and parameter specs leaf for leaf (the
port's meta tensors against the reference's ``jax.eval_shape`` results:
shapes and dtypes; a stacked leaf of the reference is the port's
per-layer leaves, each its shape without the layer axis), and the
analytic ``hbm_bytes_estimate`` / ``flops_estimate`` floats to rel 1e-12
for n_dev in {1, 256, 512}.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch import specs as jspecs

from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.launch import specs as tspecs

CELLS = [(a, s) for a in tconfigs.ARCH_IDS for s in tspecs.SHAPES]
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.int32: torch.int32}
STACKED = ("layers", "dense_layers", "shared_attn", "enc_layers",
           "dec_layers")


def _dtype(d) -> torch.dtype:
    return DTYPES[jnp.dtype(d).type]


def _ref_flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


def _port_flat(tree, path=()) -> dict:
    if isinstance(tree, torch.nn.Module):
        return {k.replace(".", "/"): v for k, v in tree.named_parameters()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


def _assert_same(port: dict, ref: dict, what):
    """Each port leaf has its reference leaf's shape (less a stacked
    leaf's layer axis) and dtype; every reference leaf is covered, a
    stacked one by as many layers as its leading axis."""
    layers: dict = {}
    for path, t in port.items():
        parts = path.split("/")
        key, stacked = path, False
        for i, p in enumerate(parts):
            if p in STACKED and i + 1 < len(parts) and parts[i + 1].isdigit():
                key = "/".join(parts[:i + 1] + parts[i + 2:])
                stacked = True
                break
        r = ref[key]
        want = tuple(r.shape[1:]) if stacked else tuple(r.shape)
        assert tuple(t.shape) == want, (what, path, tuple(t.shape), want)
        assert t.dtype == _dtype(r.dtype), (what, path, t.dtype, r.dtype)
        assert t.device.type == "meta", (what, path)
        if stacked:
            layers[key] = layers.get(key, 0) + 1
    assert set(ref) == {k for k in ref if k in layers or k in port}, what
    for key, n in layers.items():
        assert n == ref[key].shape[0], (what, key, n)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_table_and_batch_specs(arch, shape):
    assert tspecs.cell_is_runnable(arch, shape) == \
        jspecs.cell_is_runnable(arch, shape)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    _assert_same(_port_flat(tspecs.batch_specs_for(tcfg, shape)),
                 _ref_flat(jspecs.batch_specs_for(jcfg, shape)),
                 (arch, shape, "batch"))


@pytest.mark.parametrize("arch,shape", [c for c in CELLS
                                        if jspecs.SHAPES[c[1]]["kind"]
                                        == "decode"])
def test_decode_inputs(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jt, jc, _ = jspecs.decode_inputs_for(jcfg, shape)
    tt, tc, gen = tspecs.decode_inputs_for(tcfg, shape)
    assert tuple(tt.shape) == tuple(jt.shape) and tt.dtype == torch.int32
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 0
    _assert_same(_port_flat(tc), _ref_flat(jc), (arch, shape, "cache"))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_params_and_opt_state_specs(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jp = jspecs.params_specs_for(jcfg)
    tp = tspecs.params_specs_for(tcfg)
    _assert_same(_port_flat(tp), _ref_flat(jp), (arch, "params"))
    jo = jspecs.opt_state_specs_for(joptim.adamw(), jp)
    to = tspecs.opt_state_specs_for(toptim.adamw(), tp)
    for slot in ("m", "v"):
        _assert_same({k.replace(".", "/"): v for k, v in to[slot].items()},
                     _ref_flat(jo[slot]), (arch, slot))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_estimates_equal_the_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    np.testing.assert_allclose(tspecs.flops_estimate(tcfg, shape),
                               jspecs.flops_estimate(jcfg, shape),
                               rtol=1e-12)
    for n_dev in (1, 256, 512):
        for kind in (None, "train", "prefill", "decode"):
            np.testing.assert_allclose(
                tspecs.hbm_bytes_estimate(tcfg, shape, n_dev, kind),
                jspecs.hbm_bytes_estimate(jcfg, shape, n_dev, kind),
                rtol=1e-12, err_msg=f"{arch} {shape} {n_dev} {kind}")


def test_all_cells_and_shapes_are_the_references():
    assert tspecs.SHAPES == jspecs.SHAPES
    assert tspecs.LONG_OK == jspecs.LONG_OK
    assert list(tspecs.all_cells()) == list(jspecs.all_cells())
