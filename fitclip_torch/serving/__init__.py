"""Online serving (port of ``fitclip_tpu/serving``): a dynamic batcher over
encode functions (``batcher.py``), one CUDA graph per bucket of a tower
(``graphs.py``), and the embed service with its HTTP surfaces
(``embed_service.py``)."""
