"""The port's command-line tools: ``python -m dualdiff_tpu_torch.tools.<name>
<overrides>`` for ``train``, ``test``, ``val_set_gen``, ``fid_score``,
``fvd_score``, ``explore_attn``, ``explore_unet``, ``import_weights``,
``export_weights``, ``create_data`` and ``prepare_map_aux``."""
