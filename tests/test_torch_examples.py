"""``examples/quickstart_torch.py`` and ``examples/kernel_methods_torch.py``
against their references, run as users run them.

Both ports run with ``--device cpu`` beside the reference scripts, and
every number the two print must agree line by line: shapes, counts and
indices exactly, other values within rtol 2e-4, atol 2e-5 (plus one unit
in the last printed digit), the sig-MMD values within rtol 1e-5.

quickstart's section 9 holds the Hopper kernels against their plain
versions on the card; on the CPU it prints that it was skipped, and the
reference's interpret-mode section has nothing to set beside it.

kernel_methods' two regression errors come from a float32 solve: the
kernel ridge system (K + 1e-4·I) has a condition number of about 2.2e6
and the Nyström landmark Gram is singular, so the reference's and the
port's float32 answers part from the float64 one by up to 3.6% (the
reference's Nyström error), which no reordering of float32 sums can
close.  So both packages solve the demo again in float64 on the same
inputs (the reference under ``jax.enable_x64``): the port's float64
errors equal the reference's within 1e-8 relative, and each package's
printed float32 line lies within 5% of its float64 error.
"""
import re

import numpy as np
import pytest
import torch

import _torch_examples as ex

NAMES = ("quickstart_torch", "kernel_methods_torch")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    return {name: ex.run_beside_reference(name, tmp) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(runs, name):
    ex.check_runs(runs[name][0], name)


def test_quickstart_prints_the_references_numbers(runs):
    port, ref = (ex.lines(r) for r in runs["quickstart_torch"])
    cut = lambda lines: lines[:next(i for i, s in enumerate(lines)
                                    if s.startswith("--- 9."))]
    ex.compare_lines(cut(ref), cut(port))
    tail = port[len(cut(port)):]
    assert tail[0].startswith("--- 9. Hopper kernels against their plain "
                              "versions")
    assert tail[1] == "needs the card: skipped, the caller asked for the CPU"
    assert "Chen identity max|err|" in "\n".join(port)
    assert runs["quickstart_torch"][0].value == {"plain_checks": []}


KRR = r"KRR rmse|Nystrom\("


def test_kernel_methods_prints_the_references_numbers(runs):
    port, ref = (ex.lines(r) for r in runs["kernel_methods_torch"])
    keep = lambda lines: [s for s in lines if not re.search(KRR, s)]
    ex.compare_lines(keep(ref), keep(port), rtol_by=[(r"MMD\^2", 1e-5)])
    assert "6/6 streams retrieve their own reference" in port[-1]
    gram, = runs["kernel_methods_torch"][0].value["plain_checks"]
    assert gram["kernel"] == "sig_gram" and gram["ok"]


def _demo_inputs():
    """The KRR demo's train and test paths, float32 draws held in
    float64."""
    km = ex.load_example("kernel_methods_torch")
    return (km.walks(48, 24, 2, "cpu", seed=4).double(),
            km.walks(12, 24, 2, "cpu", seed=5).double())


def _port_float64_rmse(train, test) -> tuple[float, float, float]:
    """The port's KRR and Nyström errors of the demo in float64, and the
    KRR system's condition number."""
    from repro_torch.core import tensor_ops as tops
    from repro_torch.sigkernel import (fit_sig_krr, nystrom_features,
                                       sig_gram)

    def target(p):
        inc = tops.path_increments(p)
        return (torch.cumsum(inc[..., 0], -1)[:, :-1]
                * inc[:, 1:, 1]).sum(-1)

    model = fit_sig_krr(train, target(train), 3, reg=1e-4, device="cpu")
    krr = float(torch.sqrt(torch.mean((model.predict(test)
                                       - target(test)) ** 2)))
    ny = nystrom_features(train[:16], 3, device="cpu")
    w = torch.linalg.pinv(ny(train)) @ target(train)
    nys = float(torch.sqrt(torch.mean((ny(test) @ w - target(test)) ** 2)))
    K = sig_gram(train, train, 3, device="cpu").numpy()
    return krr, nys, float(np.linalg.cond(K + 1e-4 * np.eye(len(K))))


def _reference_float64_rmse(train, test) -> tuple[float, float]:
    """The reference's KRR and Nyström errors of the demo in float64, as
    its script computes them (Nyström by ``lstsq(rcond=None)``)."""
    import jax
    import jax.numpy as jnp
    from repro.core import tensor_ops as rtops
    from repro.sigkernel import fit_sig_krr, nystrom_features

    def target(p):
        inc = rtops.path_increments(p)
        return (jnp.cumsum(inc[..., 0], -1)[:, :-1] * inc[:, 1:, 1]).sum(-1)

    with jax.enable_x64(True):
        tr, te = jnp.asarray(train.numpy()), jnp.asarray(test.numpy())
        model = fit_sig_krr(tr, target(tr), 3, reg=1e-4)
        pred = model.predict(te)
        assert pred.dtype == jnp.float64
        krr = float(jnp.sqrt(jnp.mean((pred - target(te)) ** 2)))
        ny = nystrom_features(tr[:16], 3)
        w, *_ = jnp.linalg.lstsq(ny(tr), target(tr), rcond=None)
        nys = float(jnp.sqrt(jnp.mean((ny(te) @ w - target(te)) ** 2)))
    return krr, nys


def test_kernel_methods_regression_errors_are_float32s_spread(runs):
    train, test = _demo_inputs()
    krr64, nys64, cond = _port_float64_rmse(train, test)
    ref_krr64, ref_nys64 = _reference_float64_rmse(train, test)
    # in float64 the two packages give one answer
    assert abs(krr64 - ref_krr64) <= 1e-8 * ref_krr64, (krr64, ref_krr64)
    assert abs(nys64 - ref_nys64) <= 1e-8 * ref_nys64, (nys64, ref_nys64)
    assert cond > 1e6               # the spread's cause: an ill-posed solve
    for run in runs["kernel_methods_torch"]:
        lines = ex.lines(run)
        krr = next(s for s in lines if "KRR rmse" in s)
        nys = next(s for s in lines if "Nystrom(" in s)
        assert ex.numbers(nys)[0] == "16"         # the feature count
        got_krr, base = (float(x) for x in ex.numbers(krr))
        got_nys = float(ex.numbers(nys)[1])
        assert abs(got_krr - ref_krr64) <= 0.05 * ref_krr64, (krr, ref_krr64)
        assert abs(got_nys - ref_nys64) <= 0.05 * ref_nys64, (nys, ref_nys64)
        assert got_krr < 0.2 * base and got_nys < 0.2 * base
