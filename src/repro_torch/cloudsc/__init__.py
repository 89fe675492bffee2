from .erosion import erosion_program, physical_inputs  # noqa: F401
from .scheme import (  # noqa: F401
    mini_cloudsc_program,
    saturation_chain_inputs,
    saturation_chain_program,
    scheme_inputs,
)
