"""Tutorial entry points of the port, one module per ``examples/1-9`` script
of the repository (the reference's ``scripts/tutorials``):

    python -m synthsr_tpu_torch.examples.tutorial_1_sr_real

Each runs on the GPU unless ``SYNTHSR_DEVICE=cpu``; ``SYNTHSR_DATA``,
``SYNTHSR_RESULTS`` and ``SYNTHSR_SMOKE`` are read as ``examples/common.py``
reads them (see :mod:`.common`).  Importing a tutorial runs nothing.
"""
