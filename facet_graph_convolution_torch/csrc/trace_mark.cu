// Device marks: empty kernels that name a point of a train step in a
// device trace (utils/profiling.py::mark). A mark is one launch of one
// thread that does nothing; its kernel's name is the mark's, so a trace
// reads it plainly (fgc_mark_fwd_end). Launched on the caller's stream, it
// is captured into a CUDA graph like any other launch and replays with
// every step, which a host span cannot do.
//
// FGC_MARK(name) defines the kernel fgc_mark_<name> and its launcher
// fgc_mark_launch_<name>(stream), which returns cudaGetLastError() after
// the launch (0 when it was accepted). utils/profiling.py::MARKS lists the
// names.

#include <cuda_runtime.h>

#define FGC_MARK(name)                                                   \
  extern "C" __global__ void fgc_mark_##name() {}                        \
  extern "C" int fgc_mark_launch_##name(void* stream) {                  \
    fgc_mark_##name<<<1, 1, 0, (cudaStream_t)stream>>>();                \
    return (int)cudaGetLastError();                                      \
  }

FGC_MARK(step_begin)
FGC_MARK(fwd_end)
FGC_MARK(bwd_end)
FGC_MARK(opt_end)
FGC_MARK(solver_begin)
FGC_MARK(solver_end)
FGC_MARK(solver_bwd_begin)
FGC_MARK(solver_bwd_end)
FGC_MARK(rotinv_begin)
FGC_MARK(rotinv_end)
FGC_MARK(rotinv_bwd_begin)
FGC_MARK(rotinv_bwd_end)

#undef FGC_MARK
