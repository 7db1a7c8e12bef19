"""Distributed serving (counterpart of `deepspeed_tpu/serving/`): a router
over a pool of ServingEngine replicas.

  * `ServingRouter` (`router.py`) — scores replicas per request on
    prefix-cache affinity, load and health; bounded admission (shed or
    block), per-request TTL, quarantine / reroute / restart under the
    `elasticity/restart_policy.py` budget, the hung-replica watchdog,
    hedged dispatch, hard deadlines, and disaggregated prefill/decode
    (`kv_cache.transplant_blocks` moves a prefilled slot's blocks);
  * `ReplicaHandle` / `InProcessReplica` (`replica.py`) — the protocol the
    router drives;
  * the multi-process fabric: `transport.py` (length-prefixed frames,
    RPC, heartbeat push), `remote_replica.py` (`RemoteReplica`,
    `ReplicaProcess`, heartbeat-budget liveness, respawn) and
    `replica_server.py` (the child's entry point), with the observability
    spool (`observability.py`) that ships each process's spans home;
  * `PressureController` (`degradation.py`) — the degradation ladder.

The reference's `Autoscaler` / `AutoscalerConfig` are the next slice of
the port: their names raise `NotImplementedError` here.
"""

from deepspeed_tpu_torch.serving.degradation import PressureController
from deepspeed_tpu_torch.serving.remote_replica import (RemoteConfig,
                                                        RemoteReplica,
                                                        ReplicaProcess)
from deepspeed_tpu_torch.serving.replica import (InProcessReplica,
                                                 ReplicaHandle,
                                                 ReplicaUnavailableError)
from deepspeed_tpu_torch.serving.router import RouterConfig, ServingRouter

__all__ = ["ServingRouter", "RouterConfig", "ReplicaHandle",
           "InProcessReplica", "PressureController",
           "ReplicaUnavailableError", "RemoteReplica", "RemoteConfig",
           "ReplicaProcess"]

_NEXT_SLICE = ("Autoscaler", "AutoscalerConfig")


def __getattr__(name):
    if name in _NEXT_SLICE:
        raise NotImplementedError(
            f"serving.{name} is not ported to deepspeed_tpu_torch yet (the "
            f"next slice of ROADMAP queue 1 item 10: the autoscaler; the "
            f"JAX package deepspeed_tpu serves it)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
