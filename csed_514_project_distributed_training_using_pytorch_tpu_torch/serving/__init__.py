"""Serving: the continuous-batching engine over the LM's contiguous or paged KV cache."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.engine import (
    Completion,
    ContinuousBatchingEngine,
    KVPagesExhausted,
    filter_logits_per_slot,
    greedy_chunk_plan,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.pagepool import (
    PagePool,
    PagePoolExhausted,
    pages_for,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    Request,
    SamplingParams,
)

__all__ = ["Completion", "ContinuousBatchingEngine", "KVPagesExhausted", "PagePool",
           "PagePoolExhausted", "Request", "SamplingParams", "filter_logits_per_slot",
           "greedy_chunk_plan", "pages_for"]
