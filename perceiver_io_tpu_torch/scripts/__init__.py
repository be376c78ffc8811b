"""The task CLIs of the port (counterpart of ``perceiver_io_tpu/scripts/``;
reference: perceiver/scripts/*): auto-CLI entry points over the config
dataclasses.

Each task module exposes ``main(argv)`` and runs as
``python -m perceiver_io_tpu_torch.scripts.<domain>.<task> fit --model.* --data.*``
(``scripts.timeseries`` at the top; the text CLIs are ``scripts.text.clm``,
``mlm``, ``classifier`` and ``preproc``).
"""
