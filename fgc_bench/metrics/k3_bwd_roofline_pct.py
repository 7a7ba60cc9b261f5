"""``k3_bwd_roofline_pct``: K3's backward (``weighted_aggregate_bwd_kernel``)
against its roofline (layer: rotation-invariant conv). Σ bound ÷ Σ device
time over its launches in the traced stretch.

A launch's bound, on the real nodes N of the conv's level with S live
slots, input width C and M filters, is the larger of its bytes at the HBM
rate and its operations at the float32 rate: read once each, the logits
S·M and the multipliers S (float32), ``x_slots`` S·C and ``dz`` N·M·C;
written once, ``dlogits`` S·M (float32). No ``dx``: at conv1 the input is
data and takes no gradient. Operations S·M·(4C+10) (dq and the softmax's
Jacobian, as K2's slot work)."""

from fgc_bench.core import peaks
from fgc_bench.metrics.k3_fwd_roofline_pct import k3_share

KERNEL = "weighted_aggregate_bwd_kernel"


def launch_bound_s(n, slots, c, m, width):
    nbytes = 4 * (2 * slots * m + slots) + width * (slots * c + n * m * c)
    ops = slots * m * (4 * c + 10)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS)


def read(ctx):
    return k3_share(ctx, KERNEL, launch_bound_s)
