"""Query execution: the push-model ExecPlan, streaming (chunked)
aggregation, the compiled static-capacity pipeline and its distributed
form over a process group."""

from .compiled import CompiledPipeline, PipelineBuilder  # noqa: F401
from .dist_compiled import (DistCompiledPipeline,  # noqa: F401
                            DistPipelineBuilder)
from .plan import (Declaration, ExecNode, ExecPlan, aggregate_node,  # noqa: F401
                   filter_node, join_node, order_by_node, project_node,
                   sink_node, source_node)
from .streaming import (StreamingAggregator, StreamingGroupBy,  # noqa: F401
                        run_streaming_aggregate)
