"""The model stack of the port (port of ``repro.models``): the dense decoder.

* ``layers`` — rope, attention (K5 through ``kernels.ops``), the SwiGLU FFN;
* ``model``  — init, forward, decode and slot-batched decode (K4 norms);
* ``convert`` — the reference's parameters carried into the port;
* ``plain``  — the fp32 forward the tests and ``chip_smoke.py`` hold it to.
"""
