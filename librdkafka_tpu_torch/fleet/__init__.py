"""Fleet subsystem, the port's copy of the JAX package's ``fleet``: a
multi-process client traffic simulator.

"Millions of users" traffic is many client processes misbehaving
together, not one fast loop — this package spawns tens-to-hundreds of
real client OS processes (producers and consumer-group members,
``fleet/_worker.py`` executed by path) against the supervised
out-of-process cluster (the chaos tier's rig), drives them with generative
traffic shapes (``traffic.py``: diurnal ramps, burst/quiet cycles,
Zipf hot keys, hot-partition skew, fan-out groups), merges their
streamed ledgers into per-group delivery oracles, and aggregates
fleet metrics (msgs/s, per-client p99, recovery envelopes).

See FLEET.md for the worker line protocol, the traffic-shape catalog,
the environment fault-verb table, and the metrics schema.
"""
from .driver import FleetDriver  # noqa: F401
from .scenarios import SCENARIOS, FleetRun  # noqa: F401
from .traffic import (TrafficPlan, bursts, diurnal, flat,  # noqa: F401
                      hot_partitions, rate_at, stack, zipf)
