"""Event-driven heterogeneous FL runtime (counterpart of ``repro.runtime``):
device fleets, a virtual-clock event queue, and sync / async / buffered
execution modes, with batched and sharded client execution."""

from repro_torch.runtime.batched import batched_local_train  # noqa: F401
from repro_torch.runtime.engine import (EventDrivenRuntime,  # noqa: F401
                                        EventLoopState, RuntimeConfig)
from repro_torch.runtime.events import (EventQueue,  # noqa: F401
                                        MergedEventQueue, TrialQueueView,
                                        VirtualClock)
from repro_torch.runtime.profiles import (PROFILES, DeviceClass,  # noqa: F401
                                          Fleet, HeterogeneityProfile,
                                          VirtualFleet, get_profile,
                                          homogeneous_fleet, sample_fleet,
                                          virtual_fleet)
from repro_torch.runtime.sharded import (ShardedRound,  # noqa: F401
                                         sharded_fedavg_train)
