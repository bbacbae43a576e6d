"""Serving layer: engines, cluster, workloads, and the serving loops, the
hubs-of-hubs federation included (the reference's `repro.serving`
exports)."""
from repro_torch.serving.analytic import AnalyticEngine
from repro_torch.serving.cluster import SimCluster, make_router, run_workload
from repro_torch.serving.engine import AgentEngine, ServeResult
from repro_torch.serving.evaluator import (SimulatedSkillEvaluator,
                                           TokenSpanEvaluator)
from repro_torch.serving.federation import (FederatedSimulator, InlineShard,
                                            build_federation)
from repro_torch.serving.simulator import (EventSimulator, RoutingProfiler,
                                           ShardEventLoop, simulate_workload)
from repro_torch.serving.telemetry import TelemetryTracker
from repro_torch.serving.workload import (DAG_WORKLOADS, WORKLOADS,
                                          ArrivalProcess, DagScript, DagStep,
                                          DialogueScript, PoissonArrivals,
                                          SyncArrivals, TraceArrivals,
                                          WorkloadSpec, generate,
                                          iter_dialogues, load_trace,
                                          make_arrivals, validate_dag)
