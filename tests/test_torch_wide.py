"""Wide convs (C = 256, M = 32 to 64) in the port, on the CPU, and the serving
refusal of networks the drivers do not run.

K1 takes a conv wider than one launch as channel chunks in its wrapper
(``fwd_in_chunks``); here the chunk logic runs with the plain K1 as the
per-chunk function and is held against the plain K1 on the whole width, and
the wrapper's M limit is taken over every chunk. The conv at C = 256 and
M = 9 or 32, and at M = 33 and 64, through ``FacetConvEpilogue`` (plain
K1/K2 on CPU tensors) is held against ``facet_conv_pallas(interpret=True)`` of the JAX
package, values and gradients. Tolerance atol 1e-5 (float32 sums in another
order; the chunked K1 computes each channel exactly as the whole one does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.graph.convert import dedupe_klist, split_self_klist
from facet_graph_convolution_tpu.ops.conv import FacetConvVariant as JaxVariant
from facet_graph_convolution_tpu.ops.conv import init_facet_conv
from facet_graph_convolution_tpu.ops.pallas_conv import facet_conv_pallas, slot_major_arrays
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.inference.driver import infer_directory
from facet_graph_convolution_torch.models.unet import init_unet
from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
from facet_graph_convolution_torch.ops.conv import FacetConvVariant, facet_conv

ATOL = 1e-5
SMALL = dict(channels=(8, 16, 32), num_filters=4, fc_channels=32)


def _tables(rng, n, k):
    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        deg = int(rng.integers(0, k - 1))
        adj[i, 1:1 + deg] = rng.choice(n, size=deg, replace=True) + 1
    a_u, mult = dedupe_klist(adj)
    return slot_major_arrays(*split_self_klist(a_u, mult))


def _epilogue_inputs(rng, n, k, c_in, m):
    adj_sm, _, rows = _tables(rng, n, k)
    n_pad = adj_sm.shape[1]
    return (torch.as_tensor(rng.normal(size=(n_pad, c_in + m)).astype(np.float32)),
            torch.as_tensor(rng.normal(size=(n_pad, m)).astype(np.float32)),
            torch.as_tensor(adj_sm), torch.as_tensor(rows[:, :, 0]),
            torch.as_tensor(rng.normal(size=(m,)).astype(np.float32)))


@pytest.mark.parametrize("c_in,m,max_c", [
    (256, 9, 128), (256, 32, 64), (200, 9, 128), (130, 16, 128), (37, 32, 16)])
def test_fwd_in_chunks_matches_whole_width(rng, c_in, m, max_c):
    """The wrapper's channel chunks, each through the plain K1, interleave
    into the plain K1's z on the whole width; ceil(C / max_c) calls."""
    args = _epilogue_inputs(rng, 90, 8, c_in, m)
    calls = []

    def chunk(cat, *rest):
        calls.append(cat.shape[1] - m)
        assert cat.is_contiguous()
        return k1.facet_conv_fwd_plain(cat, *rest)

    z = k1.fwd_in_chunks(chunk, *args, max_c)
    want = k1.facet_conv_fwd_plain(*args)
    assert z.shape == want.shape == (args[0].shape[0], m * c_in)
    np.testing.assert_allclose(z.numpy(), want.numpy(), atol=ATOL)
    assert len(calls) == -(-c_in // max_c) and sum(calls) == c_in
    assert max(calls) <= max_c


@pytest.mark.parametrize("c_in", [6, 64, 128])
def test_fwd_in_chunks_is_one_call_at_the_model_widths(rng, c_in):
    """At the paper's widths (C <= 128, M = 9) the wrapper launches K1 once a
    conv: the chunk logic hands the whole cat to one call."""
    args = _epilogue_inputs(rng, 40, 6, c_in, 9)
    calls = []

    def whole(*a):
        calls.append(a[0])
        return k1.facet_conv_fwd_plain(*a)

    k1.fwd_in_chunks(whole, *args, 128)
    assert len(calls) == 1 and calls[0] is args[0]


@pytest.mark.parametrize("c_in,m", [(256, 32), (256, 9), (64, 32), (64, 33), (32, 64)])
def test_wide_conv_matches_jax_pallas(rng, c_in, m):
    """The conv at wide C and M through FacetConvEpilogue on the CPU (plain
    K1 forward, plain K2 backward) against jax.grad of facet_conv_pallas in
    interpret mode: values and the gradients of w, b, u, v, c and x."""
    n = 70
    adj_sm, adj_t_sm, mult_rows = _tables(rng, n, 8)
    assert mult_rows.shape[1] > n
    x = rng.normal(size=(n, c_in)).astype(np.float32)
    r = rng.normal(size=(n, 8)).astype(np.float32)
    jparams = init_facet_conv(jax.random.PRNGKey(c_in + m), c_in, 8, m,
                              variant=JaxVariant("default"))
    tables = [jnp.asarray(t) for t in (adj_sm, adj_t_sm, mult_rows)]

    def jloss(p, xx):
        y = facet_conv_pallas(p, xx, *tables, interpret=True)
        return jnp.sum(y * r), y

    (_, y_j), (g_p, g_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))

    params = {k: v.requires_grad_() for k, v in params_io.params_from_jax(
        {"c": jax.tree.map(np.asarray, jparams)}, device="cpu")["c"].items()}
    xt = torch.as_tensor(x).requires_grad_()
    y = facet_conv(params, xt, torch.as_tensor(adj_sm), torch.as_tensor(mult_rows),
                   variant=FacetConvVariant.DEFAULT, adj_t_sm=torch.as_tensor(adj_t_sm))
    (y * torch.as_tensor(r)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=ATOL)
    assert set(params) == set(g_p) == {"w", "b", "u", "v", "c"}
    for name in g_p:
        np.testing.assert_allclose(params[name].grad.numpy(), np.asarray(g_p[name]),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=ATOL)


class _FakeLibrary:
    """K1's library as the wrapper sees it: its limits, with the channel
    widths it was asked about recorded."""

    def __init__(self):
        self.asked = []

    def facet_conv_fwd_max_c(self):
        return 1024

    def facet_conv_fwd_max_m(self, k_nbr, c_in):
        self.asked.append((k_nbr, c_in))
        return 5000 - c_in

    def facet_conv_bwd_max_m(self):
        return 4842


@pytest.mark.parametrize("c_in,widths", [
    (6, {6}), (64, {64}), (1024, {1024}), (1030, {1024, 6}), (2048, {1024})])
def test_max_m_holds_for_every_channel_chunk(c_in, widths):
    """The largest M the wrapper lets through is the smallest over the channel
    widths K1 is launched at (the whole C, or its chunks of 1024 and the
    remainder); K2's does not depend on the shape."""
    lib = _FakeLibrary()
    assert k1._max_m("facet_conv_fwd", lib, 12, c_in) == 5000 - max(widths)
    assert {w for _, w in lib.asked} == widths and {k for k, _ in lib.asked} == {12}
    assert k1._max_m("facet_conv_bwd", lib, 12, c_in) == 4842


@pytest.mark.parametrize("variant,cause", [
    (FacetConvVariant.TRANSLATION_INVARIANT, "translation-invariant network"),
    (FacetConvVariant.ROTATION_INVARIANT, "rotation-invariant conv1")])
def test_serving_refuses_a_checkpoint_by_its_variant(tmp_path, variant, cause):
    """A params.pt of a translation-invariant network (no v in any conv) or
    a rotation-invariant one (no v in conv1 only) is refused, naming its
    variant, whether the normals or the vertex pipeline is asked for."""
    params = init_unet(0, device="cpu", variant=variant, **SMALL)
    convs = [layer for layer, p in params.items() if "u" in p]
    has_v = [layer for layer in convs if "v" in params[layer]]
    assert has_v == ([] if variant == FacetConvVariant.TRANSLATION_INVARIANT else convs[1:])
    cfg = default_config().replace(
        train={"network_path": str(tmp_path / "Networks") + "/", "net_name": "net"},
        eval={"results_path": str(tmp_path / "out") + "/"})
    path = params_io.checkpoint_path(cfg.train.network_path, cfg.train.net_name)
    params_io.save(params, path)
    for with_vertices in (False, True):
        with pytest.raises(ValueError, match=cause):
            infer_directory(str(tmp_path), cfg, with_vertices=with_vertices, device="cpu")
