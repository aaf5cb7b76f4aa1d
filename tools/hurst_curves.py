"""The §8 Hurst training curves of the port and the reference side by side.

Both models at the small width of ``tests/test_torch_hurst.py`` (B 8, M 20,
d 2, depth 3), from the same seed and data, the parameters aligned by
``convert.hurst_params_from_reference``, 20 full-batch Adam steps at
lr 1e-2, in float32 and in float64.  Prints, for each kind, the largest
relative gap of the loss curves: port against reference in float32 and in
float64, and each package's float32 curve against its own float64 one.

Run:  PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tools/hurst_curves.py
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_hurst as T
from repro_torch.convert import hurst_params_from_reference

LR, STEPS = 1e-2, 20


def curves(kind: str) -> dict:
    X, H, params, apply, model = T._models(kind, 3)
    out = {"ref32": T._ref_adam_curve(params, apply, X, H, LR, STEPS,
                                      jnp.float32),
           "port32": T._port_adam_curve(model, X, H, LR, STEPS)}
    with jax.enable_x64(True):
        _, apply64, _ = T.ref.make_model(kind, 2, 3, 20,
                                         jax.random.PRNGKey(0),
                                         jnp.asarray(X, jnp.float64))
        out["ref64"] = T._ref_adam_curve(params, apply64, X, H, LR, STEPS,
                                         jnp.float64)
    m64 = T.port.HurstModel(kind, 2, 3, 20, device="cpu")
    m64.load_state_dict(hurst_params_from_reference(params, "cpu"))
    m64 = m64.double()
    m64.whiten(torch.from_numpy(X).double())
    out["port64"] = T._port_adam_curve(m64, X, H, LR, STEPS)
    return out


def gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b) / np.abs(b)))


def main() -> int:
    for kind in ("truncated", "sparse"):
        c = curves(kind)
        print(json.dumps({
            "kind": kind, "first_loss": c["ref32"][0],
            "last_loss": c["ref32"][-1],
            "port32_ref32": gap(c["port32"], c["ref32"]),
            "port64_ref64": gap(c["port64"], c["ref64"]),
            "ref32_ref64": gap(c["ref32"], c["ref64"]),
            "port32_port64": gap(c["port32"], c["port64"])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
