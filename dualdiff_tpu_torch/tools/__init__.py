"""The port's command-line tools: ``python -m dualdiff_tpu_torch.tools.<name>
<overrides>`` for ``train``, ``test`` and ``val_set_gen``."""
