"""The main module of an env worker process.

A forkserver or spawn worker imports its parent's main module before it
runs its target. `env/vector.py` names this module instead while it
starts workers, so a worker does not re-run the parent's script (and
its imports of torch); the worker's own code lives in `env/vector.py`
and the env modules.
"""
