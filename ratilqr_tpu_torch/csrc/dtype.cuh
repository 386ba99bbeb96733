// The working type of one translation unit.  ops/_build.py compiles every
// kernel source twice, with -DRQ_DTYPE=0 (float32) and -DRQ_DTYPE=1
// (float64), so each type's instantiations build in their own nvcc
// process; RQ_ENTRY names the C entry point of that type
// (ratilqr_step_f32, ratilqr_step_f64, ...).
#pragma once

#if !defined(RQ_DTYPE)
#error "compile with -DRQ_DTYPE=0 (float32) or -DRQ_DTYPE=1 (float64)"
#elif RQ_DTYPE == 0
using Real = float;
#define RQ_ENTRY(name) name##_f32
#elif RQ_DTYPE == 1
using Real = double;
#define RQ_ENTRY(name) name##_f64
#else
#error "RQ_DTYPE must be 0 (float32) or 1 (float64)"
#endif
