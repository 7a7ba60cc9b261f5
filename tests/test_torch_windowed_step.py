"""The halo-sharded path with windowed levels (K5 through its plain version,
and the unfused windowed gather) against the port's flat step and the JAX
package's flat step, on the CPU.

One noisy ``icosphere(3)`` patch padded so that 1, 2 and 4 shards divide
every level (``tests/test_torch_halo.py``'s), channels 8/16/32, M = 4,
fc 32, and windows forced on from 64 rows a shard in slabs of 128 rows (64
at D = 4): level 0 runs the windowed conv at every D (with the halo pack at
D > 1), level 1 at D = 1, level 2 stays on K1/K2. The port's ranks are gloo
processes (``tests/torch_halo_ranks.py``, the settings passed in the
payload). Three Adam steps on JAX's rotations and masks:

- the windowed step against the port's flat step: losses within 1e-5
  relative, the parameters after each step within 1e-5 (the same sums
  reassociated); the first step's gradients within 1e-4 × max|g| a leaf;
- against JAX's flat step: the bounds of ``tests/test_torch_halo.py``
  (losses rtol 1e-4, parameters and the first step's gradients atol 3e-4).
  JAX's own windowed step misses its flat step at rtol 1e-5 over 6 steps
  (ROADMAP queue 3), so the comparison is with its flat step.
- the forward (``sharded_unet_apply``) at D = 1 and 2 against the flat
  forward within 1e-5;
- bfloat16 at D = 2: the windowed step against JAX's bfloat16 flat step
  (0.03 × its losses, gradients 0.05 × max|g|, ``tests/test_variant_matrix.py``),
  and ``remat``, which leaves K5's convs unwrapped, bit for bit.
"""

import jax
import numpy as np
import pytest

from facet_graph_convolution_tpu.parallel import halo as jax_halo
from facet_graph_convolution_torch.parallel import halo
from tests.test_torch_halo import (
    CPU,
    _assert_grads_close,
    _assert_params_close,
    _cfgs,
    _draws,
    _jax_grads,
    _jax_steps,
    _train_payload,
    jax_params,  # noqa: F401  (a fixture)
    patch,  # noqa: F401  (a fixture)
)
from tests.torch_halo_ranks import job_forward, job_train, run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _settings(shards, fused):
    return {"_WINDOWED_FUSED": fused, "WINDOWED_MIN_NODES": 64,
            "WINDOWED_BLOCK": 64 if shards >= 4 else 128}


@pytest.fixture
def jax_flat(monkeypatch):
    monkeypatch.setattr(jax_halo, "WINDOWED_MIN_NODES", 10**9)


def _run(payload, shards, settings, tmp_path, job="train"):
    """Rank 0's results of ``job`` at ``shards`` (the train job's losses
    equal on every rank)."""
    if shards == 1:
        saved = {name: getattr(halo, name) for name in settings}
        try:
            for name, value in settings.items():
                setattr(halo, name, value)
            return {"train": job_train, "forward": job_forward}[job](payload, CPU)
        finally:
            for name, value in saved.items():
                setattr(halo, name, value)
    out = run_ranks(job, shards, dict(payload, halo_settings=settings), str(tmp_path))
    for other in out[1:] if job == "train" else ():
        for name in out[0]:
            assert other[name]["losses"] == out[0][name]["losses"]
    return out[0]


@pytest.mark.parametrize("shards", [1, 2])
def test_windowed_forward_matches_flat(patch, jax_params, shards, tmp_path):  # noqa: F811
    payload = {"adjs": [np.asarray(a) for a in patch.adjs], "x": patch.inputs,
               "params": {"default": jax_params["default"]}}
    win = _run(payload, shards, _settings(shards, True), tmp_path / "w", "forward")
    flat = _run(payload, shards, {"WINDOWED_MIN_NODES": 10**9}, tmp_path / "f", "forward")
    np.testing.assert_allclose(win["default"], flat["default"], atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_windowed_steps_match_flat(patch, jax_params, shards, fused, jax_flat,  # noqa: F811
                                   tmp_path):
    cfg, jcfg = _cfgs()
    keys, rots, masks = _draws(patch)
    params = jax_params["default"]
    payload = _train_payload(patch, params, {"f32": cfg}, rots, masks)
    win = _run(payload, shards, _settings(shards, fused), tmp_path / "w")["f32"]
    flat = _run(payload, shards, {"WINDOWED_MIN_NODES": 10**9}, tmp_path / "f")["f32"]
    geoms = win["windows"]
    assert geoms[0] is not None and geoms[2] is None and (geoms[1] is not None) == (shards == 1)
    assert (geoms[0][3] > geoms[0][4]) == (shards > 1)     # the halo pack at D > 1
    assert flat["windows"] == [None, None, None]

    np.testing.assert_allclose(win["losses"], flat["losses"], rtol=1e-5)
    _assert_params_close(win["params"], flat["params"], None, atol=1e-5)
    _assert_grads_close(win["grads"][0], flat["grads"][0], rel=1e-4)

    want_losses, want_params = _jax_steps(jcfg, params, patch, shards, keys, masks)
    np.testing.assert_allclose(win["losses"], want_losses, rtol=1e-4)
    _assert_params_close(win["params"], want_params, params, atol=3e-4)
    _assert_grads_close(win["grads"][0],
                        _jax_grads(jcfg, params, patch, shards, keys[0], masks[0]), atol=3e-4)


def test_bf16_and_remat_windowed_steps(patch, jax_params, jax_flat, tmp_path):  # noqa: F811
    cfg16, jcfg16 = _cfgs(compute_dtype="bfloat16")
    keys, rots, masks = _draws(patch)
    params = jax_params["default"]
    out = run_ranks("train", 2, dict(_train_payload(
        patch, params, {"bf16": cfg16, "bf16_remat": cfg16}, rots, masks),
        halo_settings=_settings(2, True)), str(tmp_path))[0]
    assert out["bf16"]["windows"][0] is not None
    assert out["bf16"]["losses"] == out["bf16_remat"]["losses"]
    _assert_params_close(out["bf16_remat"]["params"], out["bf16"]["params"], None, atol=0)
    want_losses, _ = _jax_steps(jcfg16, params, patch, 2, keys, masks)
    got = np.asarray(out["bf16"]["losses"])
    assert np.all(np.abs(got - want_losses) <= 0.03 * np.abs(want_losses))
    _assert_grads_close(out["bf16"]["grads"][0],
                        _jax_grads(jcfg16, params, patch, 2, keys[0], masks[0]), rel=0.05)
