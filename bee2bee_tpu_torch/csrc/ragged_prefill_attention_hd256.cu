// The head_dim-256 instantiations of the ragged prefill kernels (the bf16
// tile kernel and its f32 form, both pool forms, BS 8, 16 and 32): the
// whole of ragged_prefill_attention.cu compiled with RAGGED_PREFILL_HD256,
// as a library of its own with the same C entry points, so that its nvcc
// runs beside that file's rather than lengthening it. ops/ragged.py loads
// it for head_dim 256.

#define RAGGED_PREFILL_HD256
#include "ragged_prefill_attention.cu"
