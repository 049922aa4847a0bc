"""Runtime services of the port (port of ``repro/runtime``): so far the
deterministic fault injector behind the checkpoint/resume tests."""
from repro_torch.runtime import faultinject
from repro_torch.runtime.faultinject import FaultInjector, InjectedFault, Rule

__all__ = ["faultinject", "FaultInjector", "InjectedFault", "Rule"]
