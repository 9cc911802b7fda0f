from .engine import (BranchHandle, ChunkedPrefillState, Engine,
                     EngineConfig, StepVariant)
from .faults import (CorruptedLogitsFault, EngineCrashFault, FaultInjector,
                     FaultPlan, InjectedFault, InjectedStepFault,
                     PoisonedRequestFault)
from .sampling import SamplingParams, sample

__all__ = ["BranchHandle", "ChunkedPrefillState", "Engine", "EngineConfig",
           "SamplingParams", "StepVariant", "sample",
           "CorruptedLogitsFault", "EngineCrashFault", "FaultInjector",
           "FaultPlan", "InjectedFault", "InjectedStepFault",
           "PoisonedRequestFault"]
