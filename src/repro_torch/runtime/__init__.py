"""Runtime services of the port (port of ``repro/runtime``): gradient
compression, restart orchestration, elastic resharding and the
deterministic fault injector. The reference's ``degrade`` chains are not
ported (ROADMAP C7)."""
from repro_torch.runtime.compression import compress_tree_grads, topk_compress
from repro_torch.runtime.fault import FaultPolicy, run_with_restarts
from repro_torch.runtime.elastic import reshard_state
from repro_torch.runtime import faultinject
from repro_torch.runtime.faultinject import FaultInjector, InjectedFault, Rule

__all__ = ["compress_tree_grads", "topk_compress", "FaultPolicy",
           "run_with_restarts", "reshard_state", "faultinject", "FaultInjector",
           "InjectedFault", "Rule"]
