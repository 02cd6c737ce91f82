"""End-to-end applications (the ported part of `cvt_tpu.apps`): image
retrieval over local descriptors."""

from cvt_tpu_torch.apps.retrieval import ImageRetrievalIndex

__all__ = ["ImageRetrievalIndex"]
