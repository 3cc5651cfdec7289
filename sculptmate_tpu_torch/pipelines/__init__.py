"""User-facing generator facades."""

from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator, TripoGenerator  # noqa: F401
