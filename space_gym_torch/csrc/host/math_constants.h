// Stand-in for <math_constants.h>: the constants the kernels use.
#pragma once
#include <limits>
#define CUDART_INF_F std::numeric_limits<float>::infinity()
