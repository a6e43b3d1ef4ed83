"""Query execution: the compiled static-capacity pipeline."""

from .compiled import CompiledPipeline, PipelineBuilder  # noqa: F401
