"""The port's CPU reference renderer, the golden oracle (port of
``xr/cpu_ref``): ``render_frame`` and ``visibility_bbox`` in ``oracle``,
the shadow-ambiguity mask in ``margins`` and the independent scalar
rasterizer that validates the oracle in ``brute``."""
from xr_torch.cpu_ref.oracle import render_frame, visibility_bbox  # noqa: F401
