from .engine import (BranchHandle, ChunkedPrefillState, Engine,
                     EngineConfig, StepVariant)
from .sampling import SamplingParams, sample

__all__ = ["BranchHandle", "ChunkedPrefillState", "Engine", "EngineConfig",
           "SamplingParams", "StepVariant", "sample"]
