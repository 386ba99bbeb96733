// A CPU stand-in for <cuda_pipeline.h>: the pipeline calls are in
// cuda_runtime.h beside this file.
#pragma once
#include "cuda_runtime.h"
