"""The port's package surfaces against the reference's.

Each package of ``repro`` is walked against its counterpart in
``repro_torch``: every name of the reference's ``__all__`` is in the
port's, less the documented exceptions below, and every name of the
port's ``__all__`` resolves.  Where the reference has no ``__all__``, the
port's names must be names of the reference package.
"""
import importlib
import pkgutil

import pytest

import repro

# names of the reference's __all__ the port does not export, and why
MISSING = {
    # the submodules keep these names (their functions are
    # core.signature.signature and core.logsignature.logsignature)
    "core": {"signature", "logsignature"},
    # submodule names too; the kernels are sig_trunc.sig_trunc and
    # sig_words.sig_words
    "kernels": {"sig_trunc", "sig_words"},
    # instrument_jit has no counterpart: the port has no jit, and
    # launch-shape accounting (obs.compile.count_new_shape) plays its role
    "obs": {"instrument_jit"},
}
# names the port exports that the reference's __all__ leaves out
EXTRA = {"obs": {"breached", "report"}}
# reference packages the port does not have yet
ABSENT: set = set()

PACKAGES = sorted(m.name for m in pkgutil.iter_modules(repro.__path__)
                  if m.ispkg)


def test_every_package_is_walked():
    assert {"core", "kernels", "models", "ragged", "serve", "sigkernel",
            "obs", "optim", "train", "data", "checkpoint"} <= set(PACKAGES)
    assert ABSENT <= set(PACKAGES)


@pytest.mark.parametrize("name", [p for p in PACKAGES if p not in ABSENT])
def test_package_surface_equals_the_reference(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    port_all = set(getattr(port, "__all__", ()))
    for n in port_all:
        assert getattr(port, n, None) is not None, n
    if not hasattr(ref, "__all__"):
        assert not [n for n in port_all if not hasattr(ref, n)]
        return
    ref_all = set(ref.__all__)
    assert ref_all - port_all == MISSING.get(name, set())
    assert port_all - ref_all == EXTRA.get(name, set())


def test_absent_packages_are_absent():
    for name in ABSENT:
        with pytest.raises(ImportError):
            importlib.import_module(f"repro_torch.{name}")


def test_documented_renames():
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    from repro_torch.kernels import sig_gram, sig_trunc, sig_words
    assert kernels.sig_gram_tiles is sig_gram.sig_gram
    assert callable(sig_trunc.sig_trunc) and callable(sig_words.sig_words)
    assert callable(core.signature.signature)
    assert callable(core.logsignature.logsignature)


def test_launch_modules_are_the_references():
    """Every module of ``repro.launch`` has its counterpart, the dry run
    and its specs included."""
    import repro.launch as J
    import repro_torch.launch as T
    ref = {m.name for m in pkgutil.iter_modules(J.__path__)}
    port = {m.name for m in pkgutil.iter_modules(T.__path__)}
    assert ref <= port, ref - port
    from repro_torch.launch import dryrun, specs
    assert callable(dryrun.lower_cell) and callable(dryrun.rules_for)
    assert callable(specs.params_specs_for)


def test_models_surface_is_the_reference():
    import repro.models as J
    import repro_torch.models as T
    assert T.__all__ == J.__all__
