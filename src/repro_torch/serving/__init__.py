"""Continuous-batching serving of the port: slot KV cache, scheduler,
synthetic streams, engine."""
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import Completion, Request, Scheduler
from repro_torch.serving.stream import synthetic_stream

__all__ = ["ServeEngine", "Scheduler", "Request", "Completion",
           "synthetic_stream"]
