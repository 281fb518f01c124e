"""PyTorch/CUDA port of the ETPNav agent's serving path.

Mirrors the layout of the JAX package `etpnav_tpu` (config, ops, models,
graph, training, serving) so each module's counterpart is easy to find.
The attention, heatmap-NMS, GroupNorm and pre-norm attention-block
kernels are CUDA C++ for Hopper (`csrc/`), built with nvcc at first use;
every other op is plain PyTorch. Entry points run on the GPU unless the caller passes
`device="cpu"`, where each kernel wrapper runs its plain version.

Importing the package itself imports no torch: the env worker processes
(`env/vector.py`) import only numpy and the env modules.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from etpnav_tpu_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
