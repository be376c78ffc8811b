"""The host data path for the port (counterpart of ``perceiver_io_tpu/data/``):
batch iteration and prefetch (``loader.py``) and the text data modules
(``text/``). Batches are numpy dicts made on the host; the trainer moves them
to the card."""
