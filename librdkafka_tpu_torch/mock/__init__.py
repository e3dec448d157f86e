"""The in-process mock cluster (``cluster.py``), the sockem
network-shaping shim (``sockem.py``) and the out-of-process tier
(``standalone.py``: one process, or ``--supervise`` with one ``_relay.py``
process a broker; ``external.py``: ``ClusterHandle``, the chaos tier's
client-side handle on the supervised rig), the port's copies of the JAX
package's ``mock`` modules.

Submodules import lazily on purpose: pulling ClusterHandle in here
eagerly would make every client import pay for the subprocess
machinery.
"""
