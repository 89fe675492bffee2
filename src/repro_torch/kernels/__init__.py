"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``gemm``            — K1, CUDA C++ (``csrc/gemm.cu``), reached through
                        ``ops.einsum2`` by the ``pallas_gemm`` recipe;
* ``nest_kernel``     — K2/K3, Triton generated per canonical nest, reached by
                        the ``pallas_nest`` / ``pallas_reduce`` recipes;
* ``rmsnorm``         — K4 and its gradient K4-bwd, CUDA C++
                        (``csrc/rmsnorm.cu``), through ``ops.rmsnorm`` in the
                        model stack (K4-bwd from its autograd function);
* ``flash_attention`` — K5 and its gradient K5-bwd, CUDA C++
                        (``csrc/flash_attention.cu``), through
                        ``ops.attention`` in the model stack (K5-bwd from its
                        autograd function);
* ``moe_gmm``         — K6 and its gradient K6-bwd, CUDA C++
                        (``csrc/moe_gmm.cu``), through ``ops.grouped_matmul``
                        in the MoE layer (K6-bwd from its autograd function).

``ref`` holds the model-stack kernels' plain versions, the gradients'
included (autograd of the plain forward functions).
"""
