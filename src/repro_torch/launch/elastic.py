"""Elastic scaling and fault tolerance (the port of ``repro.launch.elastic``).

  * **Failure detection**: every host heartbeats; the coordinator declares
    a host dead after ``timeout`` without a beat.
  * **Elastic re-mesh**: on a membership change, the largest (data', model)
    mesh the surviving hosts can build: the MODEL axis is kept whole (TP
    needs all its shards) and the DATA axis shrinks or grows.  Parameters
    are restored from the latest complete checkpoint onto the new mesh
    (``checkpoint.load_checkpoint(..., shardings=)``).
  * **Straggler mitigation**: a host that misses ``patience`` consecutive
    deadlines is treated as failed and takes the same re-mesh path
    (fail-slow == fail-stop).
  * **Data continuity**: the pipeline is a pure function of (seed, step,
    shard), so after any resize every host makes exactly its rows again.

Pure Python: it touches no device and no process group, and is
exercised with simulated clocks and failures.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    alive: bool = True


class HeartbeatTracker:
    """Coordinator-side failure detector (file/KV backend pluggable)."""

    def __init__(self, n_hosts: int, *, timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.hosts = {
            h: HostState(h, last_beat=clock()) for h in range(n_hosts)
        }

    def beat(self, host_id: int) -> None:
        st = self.hosts[host_id]
        st.last_beat = self.clock()
        st.alive = True

    def sweep(self) -> list[int]:
        """Mark dead hosts; returns newly-dead host ids."""
        now = self.clock()
        newly_dead = []
        for st in self.hosts.values():
            if st.alive and now - st.last_beat > self.timeout:
                st.alive = False
                newly_dead.append(st.host_id)
        return newly_dead

    def alive_hosts(self) -> list[int]:
        return [h for h, st in self.hosts.items() if st.alive]


def plan_elastic_mesh(
    n_alive_chips: int, *, model_parallel: int = 16, min_data: int = 1
) -> Optional[tuple[int, int]]:
    """Largest (data, model) mesh from surviving chips.

    The model axis is preserved (TP shards are not optional); data shrinks
    to the largest extent that divides the survivors.  Returns None when
    fewer than one model group survives.
    """
    data = n_alive_chips // model_parallel
    if data < min_data:
        return None
    return (data, model_parallel)


@dataclasses.dataclass
class StragglerPolicy:
    """Bounded-staleness deadline policy (fail-slow == fail-stop)."""

    deadline_s: float = 60.0
    patience: int = 3

    def __post_init__(self):
        self._misses: dict[int, int] = {}

    def report(self, host_id: int, step_time_s: float) -> bool:
        """Record a step time; True -> treat host as failed."""
        if step_time_s > self.deadline_s:
            self._misses[host_id] = self._misses.get(host_id, 0) + 1
        else:
            self._misses[host_id] = 0
        return self._misses.get(host_id, 0) >= self.patience


class ElasticController:
    """Glue: heartbeats + straggler policy -> re-mesh decisions.

    ``on_remesh(new_mesh_shape)`` is the caller's hook: it rebuilds the mesh,
    restores the latest checkpoint with new shardings
    (``load_checkpoint(..., shardings=)``), and resumes the data stream at
    (seed, step).
    """

    def __init__(self, n_hosts: int, chips_per_host: int, *,
                 model_parallel: int = 16,
                 tracker: Optional[HeartbeatTracker] = None,
                 straggler: Optional[StragglerPolicy] = None):
        self.tracker = tracker or HeartbeatTracker(n_hosts)
        self.straggler = straggler or StragglerPolicy()
        self.chips_per_host = chips_per_host
        self.model_parallel = model_parallel

    def step(self, step_times: dict[int, float]) -> Optional[tuple[int, int]]:
        """Call once per training step with per-host step times.

        Returns a new (data, model) mesh shape when a re-mesh is needed,
        else None.
        """
        changed = False
        for host, t in step_times.items():
            self.tracker.beat(host)
            if self.straggler.report(host, t):
                self.tracker.hosts[host].alive = False
                changed = True
        changed |= bool(self.tracker.sweep())
        if not changed:
            return None
        alive = len(self.tracker.alive_hosts()) * self.chips_per_host
        return plan_elastic_mesh(alive, model_parallel=self.model_parallel)
