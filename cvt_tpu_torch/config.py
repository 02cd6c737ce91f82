"""Typed configuration for the whole framework (a copy of
`cvt_tpu.config`: the same dataclasses, defaults and JSON, so each package
reads the other's files).

Replaces the reference's three config tiers (SURVEY.md §5.6): vlindex's
boost::program_options OptionManager (util/option_manager.h), JSON model
configs (int8_quan.cc:20-39), and hard-coded demo constants
(makeIdx.cpp:301-312) — with plain dataclasses that serialize to/from
JSON and feed both the library API and the CLI.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class SiftConfig:
    """Mirrors SiftExtractionOptions defaults (vlindex sift.h:44-113)."""
    max_features: int = 512
    peak_threshold: float = 0.02 / 3
    edge_threshold: float = 10.0
    first_octave: int = -1
    n_scales: int = 3
    rootsift: bool = True


@dataclass
class MatchConfig:
    """Mirrors SiftMatchingOptions defaults (sift.h:116-170)."""
    ratio: float = 0.9
    cross_check: bool = True
    max_dist: float = float("inf")


@dataclass
class SQConfig:
    l2norm: bool = True
    rounding: str = "truncate"     # cvt Int8Encode; 'round' = faiss
    scan_mode: str = "bf16"        # or 'int8'


@dataclass
class PQConfig:
    """Defaults follow the north-star budget (OPQ-M8 64-bit codes);
    the reference operating point is m=16, k=256 (IVFOPQ.cpp:56-63)."""
    m: int = 8
    k: int = 256
    kmeans_iters: int = 25
    opq: bool = True
    opq_iters: int = 8


@dataclass
class IVFConfig:
    coarse_k: int = 1024           # reference uses 8192 at 5.95M scale
    nprobe: int = 16
    bucket_cap: int | None = None


@dataclass
class RetrievalConfig:
    k_per_desc: int = 5            # makeSearch.cpp searchKnn(.., 5)
    max_dist: float = 0.1          # makeSearch.cpp:55
    angle_thresh_deg: float = 10.0
    rerank: str | None = "svf"
    rerank_depth: int = 10


@dataclass
class MeshConfig:
    dp: int = 1
    db: int = 1


@dataclass
class Config:
    sift: SiftConfig = field(default_factory=SiftConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    sq: SQConfig = field(default_factory=SQConfig)
    pq: PQConfig = field(default_factory=PQConfig)
    ivf: IVFConfig = field(default_factory=IVFConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)

        def build(tp, data):
            kwargs = {}
            for f in dataclasses.fields(tp):
                if f.name not in data:
                    continue
                v = data[f.name]
                if dataclasses.is_dataclass(f.type) or (
                        isinstance(f.type, type)
                        and dataclasses.is_dataclass(f.type)):
                    v = build(f.type, v)
                kwargs[f.name] = v
            return tp(**kwargs)

        sub = {f.name: f.default_factory for f in dataclasses.fields(cls)
               if f.default_factory is not dataclasses.MISSING}
        kwargs = {}
        for name, factory in sub.items():
            if name in raw:
                kwargs[name] = build(type(factory()), raw[name])
        if "seed" in raw:
            kwargs["seed"] = raw["seed"]
        return cls(**kwargs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())
