"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``gemm``        — K1, CUDA C++ (``csrc/gemm.cu``), reached through
                    ``ops.einsum2`` by the ``pallas_gemm`` recipe;
* ``nest_kernel`` — K2/K3, Triton generated per canonical nest, reached by
                    the ``pallas_nest`` / ``pallas_reduce`` recipes.
"""
