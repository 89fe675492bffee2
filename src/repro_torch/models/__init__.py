"""The model stack of the port (port of ``repro.models``): all six families.

* ``layers`` — rope, attention (K5 through ``kernels.ops``), the SwiGLU FFN,
  the MoE FFN (router, sort-based dispatch, K6 experts, combine), the Mamba
  block (chunked scan) and the xLSTM blocks (mLSTM, sLSTM);
* ``model``  — init, forward (block remat under grad), decode and
  slot-batched decode (K4 norms);
* ``convert`` — the reference's parameters and AdamW state carried into the
  port;
* ``plain``  — the fp32 forward the tests and ``chip_smoke.py`` hold it to.
"""
