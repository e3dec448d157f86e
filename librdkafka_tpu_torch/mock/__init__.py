"""The in-process mock cluster (``cluster.py``), the sockem
network-shaping shim (``sockem.py``) and the out-of-process tier
(``standalone.py``: one process, or ``--supervise`` with one ``_relay.py``
process a broker), the port's copies of the JAX package's ``mock``
modules.  ``external.py`` (the chaos tier's ClusterHandle) is not ported
yet.
"""
