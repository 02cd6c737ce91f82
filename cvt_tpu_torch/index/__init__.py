"""Search engines: exact flat scan, flat ADC over PQ/OPQ codes, and
IVF-ADC (inverted lists of residual PQ codes)."""

from cvt_tpu_torch.index.flat import FlatIndex
from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.index.ivf_adc import IVFADCIndex

__all__ = ["FlatIndex", "FlatADCIndex", "IVFADCIndex"]
