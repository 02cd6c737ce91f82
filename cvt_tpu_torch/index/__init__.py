"""Search engines: exact flat scan and flat ADC over PQ/OPQ codes."""

from cvt_tpu_torch.index.flat import FlatIndex
from cvt_tpu_torch.index.flat_adc import FlatADCIndex

__all__ = ["FlatIndex", "FlatADCIndex"]
