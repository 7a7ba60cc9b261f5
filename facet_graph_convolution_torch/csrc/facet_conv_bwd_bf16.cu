// K2's bfloat16 entry, facet_conv_bwd_bf16: the kernels of facet_conv_bwd.cu
// instantiated for __nv_bfloat16 storage, compiled into a library of its own
// so that nvcc builds it in parallel with the float32 one (the design and
// what bounds it: facet_conv_bwd.cu's head note).

#define FACET_CONV_BWD_BF16
#include "facet_conv_bwd.cu"
