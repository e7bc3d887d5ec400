"""Cluster-scale co-serving: multi-replica router, prefix-affinity offline
dispatch with work stealing, shared-virtual-clock fleet simulation with
dynamic membership + chaos injection, predictive autoscaling, and fleet
capacity planning (§5.4 extended to N replicas)."""
from repro_torch.cluster.controller import FleetController
from repro_torch.cluster.planner import FleetPlanner, FleetReport
from repro_torch.cluster.replica import (Replica, ReplicaLoad, ReplicaState,
                                   first_block_hash)
from repro_torch.cluster.router import ROUTER_POLICIES, Router, RouterStats
from repro_torch.cluster.simulator import (ChaosConfig, ClusterSimulator,
                                     ClusterStats, KillRecord)

__all__ = [
    "ChaosConfig", "ClusterSimulator", "ClusterStats", "FleetController",
    "FleetPlanner", "FleetReport", "KillRecord", "ROUTER_POLICIES",
    "Replica", "ReplicaLoad", "ReplicaState", "Router", "RouterStats",
    "first_block_hash",
]
