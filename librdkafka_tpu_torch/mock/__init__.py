"""The in-process mock cluster (``cluster.py``) and the sockem
network-shaping shim (``sockem.py``), the port's copies of the JAX
package's ``mock`` modules.  The out-of-process tier (``standalone.py``,
``_relay.py``, ``external.py``) is not ported yet.
"""
