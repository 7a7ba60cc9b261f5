"""The port's facet conv and its K1 module against the JAX package, on the CPU.

On CPU tensors the K1 wrapper runs its plain PyTorch version, so these tests
hold that version, and the conv around it, against
``facet_conv_pallas(interpret=True)`` (the Pallas kernel in interpret mode),
against the row-major ``facet_conv``, and against ``conv_epilogue``. All in
float32; tolerance atol 1e-5 (a few ulps of the O(1) outputs, summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.graph.convert import dedupe_klist, split_self_klist
from facet_graph_convolution_tpu.ops.conv import FacetConvVariant as JaxVariant
from facet_graph_convolution_tpu.ops.conv import facet_conv as jax_facet_conv
from facet_graph_convolution_tpu.ops.conv import init_facet_conv
from facet_graph_convolution_tpu.ops.pallas_conv import (
    conv_epilogue,
    facet_conv_pallas,
    gather_slot_major,
    slot_major_arrays,
)
from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
from facet_graph_convolution_torch.ops.conv import FacetConvVariant, facet_conv
from facet_graph_convolution_torch.params import params_from_jax

ATOL = 1e-5


def _random_graph(rng, n, k):
    """Raw one-indexed K-list: self slot, 0..k-2 random neighbours with
    repeats (so dedupe yields multiplicities), 0 pads; some rows self-only."""
    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        deg = int(rng.integers(0, k - 1))
        adj[i, 1:1 + deg] = rng.choice(n, size=deg, replace=True) + 1
    return adj


def _tables(adj):
    a_u, mult = dedupe_klist(adj)
    return slot_major_arrays(*split_self_klist(a_u, mult))


@pytest.mark.parametrize("variant", ["default", "translation_invariant"])
@pytest.mark.parametrize("n,k", [(61, 9), (300, 7)])
def test_facet_conv_matches_jax(rng, variant, n, k):
    adj = _random_graph(rng, n, k)
    assert (adj[:, 1] == 0).any()             # rows with no neighbours
    adj_sm, adj_t_sm, mult_rows = _tables(adj)
    assert mult_rows.shape[1] > n             # padded node axis exercised
    assert (mult_rows[1:, :n, 0] == 0).any()  # pad slots exercised
    x = rng.normal(size=(n, 6)).astype(np.float32)
    jvar = JaxVariant(variant)
    jparams = init_facet_conv(jax.random.PRNGKey(n), 6, 8, 4, variant=jvar)

    y_pallas = facet_conv_pallas(
        jparams, jnp.asarray(x), jnp.asarray(adj_sm), jnp.asarray(adj_t_sm),
        jnp.asarray(mult_rows), translation_invariant=variant != "default",
        interpret=True)
    y_rows = jax_facet_conv(jparams, jnp.asarray(x), jnp.asarray(adj), variant=jvar)

    params = params_from_jax({"conv": jax.tree.map(np.asarray, jparams)}, device="cpu")["conv"]
    y = facet_conv(params, torch.as_tensor(x), torch.as_tensor(adj_sm),
                   torch.as_tensor(mult_rows), variant=FacetConvVariant(variant))
    assert y.shape == (n, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_rows), atol=ATOL)


def test_kernel_module_plain_matches_conv_epilogue(rng):
    """K1's plain version against the JAX epilogue on the same gathered
    input; the CPU wrapper takes the plain path and counts no launch."""
    n, k, c_in, m = 61, 9, 5, 4
    adj_sm, adj_t_sm, mult_rows = _tables(_random_graph(rng, n, k))
    n_pad = adj_sm.shape[1]
    cat = rng.normal(size=(n_pad, c_in + m)).astype(np.float32)
    ux = rng.normal(size=(n_pad, m)).astype(np.float32)
    c = rng.normal(size=(m,)).astype(np.float32)

    gathered = gather_slot_major(jnp.asarray(cat), jnp.asarray(adj_sm), jnp.asarray(adj_t_sm))
    z_ref = conv_epilogue(gathered, jnp.asarray(cat), jnp.asarray(ux),
                          jnp.asarray(mult_rows), jnp.asarray(c).reshape(1, -1),
                          None, True)

    args = (torch.as_tensor(cat), torch.as_tensor(ux), torch.as_tensor(adj_sm),
            torch.as_tensor(mult_rows[:, :, 0]), torch.as_tensor(c))
    z_plain = k1.facet_conv_fwd_plain(*args)
    np.testing.assert_allclose(z_plain.numpy(), np.asarray(z_ref), atol=ATOL)

    before = k1.facet_conv_fwd.launches
    z = k1.facet_conv_fwd(*args)
    assert k1.facet_conv_fwd.launches == before
    np.testing.assert_array_equal(z.numpy(), z_plain.numpy())


def test_kernel_wrapper_refuses_other_devices():
    """Neither CPU nor CUDA: no kernel and no quiet fallback."""
    t = torch.zeros((8, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k1.facet_conv_fwd(t, t[:, :1], torch.zeros((2, 8), dtype=torch.int32, device="meta"),
                          torch.zeros((3, 8), device="meta"), torch.zeros((1,), device="meta"))


def test_facet_conv_rejects_unported_variant():
    """Every variant of the JAX package is ported: what the conv refuses is
    a variant that does not exist, and a rotation-invariant conv1 on inputs
    other than the reference's 3, 4 or 6 channels (model.py:452-460)."""
    params = {"u": torch.zeros(4, 5), "c": torch.zeros(4), "w": torch.zeros(4, 8, 5),
              "b": torch.zeros(8)}
    args = (params, torch.zeros(2, 5), torch.zeros(1, 8, dtype=torch.int32),
            torch.zeros(2, 8, 1))
    with pytest.raises(ValueError, match="variant"):
        facet_conv(*args, variant="scale_invariant")
    with pytest.raises(ValueError, match="3/4/6"):
        facet_conv(*args, variant=FacetConvVariant.ROTATION_INVARIANT)
