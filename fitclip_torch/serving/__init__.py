"""Online serving (port of ``fitclip_tpu/serving``): a dynamic batcher over
encode functions (``batcher.py``), one CUDA graph per bucket of a tower
(``graphs.py``), the embed service with its HTTP surfaces
(``embed_service.py``), and each tower as a ``torch.export`` program
(``export.py``, written by ``export_serving.py``) for EMBED_EXPORT_DIR."""
