"""Runnable tours of the port, counterparts of the repo's ``examples/``:
``python -m repro_torch.examples.quickstart``,
``python -m repro_torch.examples.similarity_search`` and
``python -m repro_torch.examples.serve_with_index``."""
