"""FeatureTransformer base + chaining (reference:
``$DL/transform/vision/image/FeatureTransformer.scala``: transforms one
ImageFeature, chains with ``->`` into a Pipeline; failures mark the feature
invalid instead of killing the job)."""

from __future__ import annotations

import logging
from typing import Iterable, List

from .feature import ImageFeature

log = logging.getLogger("bigdl_tpu_torch.vision")


class FeatureTransformer:
    """Transforms one :class:`ImageFeature` in place and returns it."""

    def transform(self, feature: ImageFeature) -> ImageFeature:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, feature: ImageFeature) -> ImageFeature:
        try:
            return self.transform(feature)
        except Exception:  # reference behavior: log, mark invalid, continue
            log.exception("%s failed on %r", type(self).__name__, feature.uri())
            feature[ImageFeature.IS_VALID] = False
            return feature

    def apply(self, features: Iterable[ImageFeature]) -> List[ImageFeature]:
        return [self(f) for f in features]

    def __gt__(self, other):  # pragma: no cover - parity sugar
        return self.chain(other)

    def chain(self, other: "FeatureTransformer") -> "Pipeline":
        return Pipeline([self, other])

    def __rshift__(self, other: "FeatureTransformer") -> "Pipeline":
        """``a >> b`` chains (the Scala ``->``)."""
        return self.chain(other)


class Pipeline(FeatureTransformer):
    def __init__(self, stages: List[FeatureTransformer]):
        self.stages = list(stages)

    def transform(self, feature: ImageFeature) -> ImageFeature:
        for s in self.stages:
            feature = s(feature)
            if not feature.is_valid():
                break
        return feature

    def chain(self, other: FeatureTransformer) -> "Pipeline":
        return Pipeline([*self.stages, other])
