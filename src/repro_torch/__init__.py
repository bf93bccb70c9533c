"""PyTorch/CUDA port of the AMIDST streaming-VMP toolbox.

Mirrors the layout of the JAX package ``repro`` module for module
(``repro_torch.core.vmp`` <-> ``repro.core.vmp``) and imports nothing of it
and nothing of JAX.  The main path is the paper's own loop: a ``DataStream``
of chunks -> ``PlateSpec`` -> ``vmp.local_step`` (E-step, expected
sufficient statistics through the hand-written CUDA kernels of
``repro_torch.kernels.clg_stats``) -> ``vmp.global_update`` ->
``streaming.stream_fit`` (drift detection, tempering, quarantine) ->
``pgm_models.Model.update_model`` / ``posterior_z``.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).
"""

from repro_torch.device import resolve_device  # noqa: F401
