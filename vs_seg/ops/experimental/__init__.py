"""Plain-XLA conv formulations with exactness tests and no caller on the
default path, kept until they are measured on the GPU:

  widthpack       W-packed conv formulation (free reshape of W into C)
  grouped_conv    grouped-Toeplitz conv math
"""
