"""Test-support utilities (fault injection, chaos helpers).

Port of ``sparkucx_tpu/testing``.

Not imported by production code paths except through the near-zero-cost
``faults.check`` hooks — with no fault armed, every hook is one module
attribute read and a falsy branch.
"""
