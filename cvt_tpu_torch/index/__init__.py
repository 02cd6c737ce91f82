"""Search engines: exact flat scan, int8 SQ scan, flat ADC over PQ/OPQ
codes, IVF-ADC (inverted lists of residual PQ codes), the vocabulary
tree with Hamming embedding, and the native host-side HNSW graph."""

from cvt_tpu_torch.index.flat import FlatIndex
from cvt_tpu_torch.index.flat_sq import FlatSQIndex
from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.index.hnsw import HnswIndex
from cvt_tpu_torch.index.ivf_adc import IVFADCIndex
from cvt_tpu_torch.index.vocab_he import VocabHEIndex

__all__ = ["FlatIndex", "FlatSQIndex", "FlatADCIndex", "HnswIndex",
           "IVFADCIndex", "VocabHEIndex"]
