"""The port's kernels and their plain versions. Importing this package
registers every ``fitclip::`` operator (``_build.define_op``), which is all a
loaded ``torch.export`` program of a tower needs (``serving/export.py``)."""

from fitclip_torch.ops import attention, block, fit_block, s3dg_stem  # noqa: F401
