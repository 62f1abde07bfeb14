from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                 Heartbeats, PreemptionGuard,
                                                 StragglerDetector,
                                                 plan_remesh)
