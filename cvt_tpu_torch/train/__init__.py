"""Metric-learning training: ArcFace embedding training on PyTorch
(counterpart of `cvt_tpu.train`).

Reference: pytorch_arcloss/ — LMDB dataset tooling for ArcFace-style
training (image2lmdb/{txt2lmdb.py,main.py,train_data_flow.py}). The
reference only ships the data plumbing; the capability the framework
provides is the full loop: record-store dataset -> train step with
additive-angular-margin softmax -> data-parallel steps over a mesh.
"""

from cvt_tpu_torch.train.arcface import (
    ArcFaceState, arcface_logits, arcface_loss, create_state, train_step,
    make_sharded_train_step, embed, parameters, state_from_params)
from cvt_tpu_torch.train.records import RecordDataset, RecordWriter

__all__ = [
    "ArcFaceState", "arcface_logits", "arcface_loss", "create_state",
    "train_step", "make_sharded_train_step", "embed", "parameters",
    "state_from_params", "RecordDataset", "RecordWriter",
]
