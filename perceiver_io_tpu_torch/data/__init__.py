"""The host data path for the port (counterpart of ``perceiver_io_tpu/data/``):
batch iteration and prefetch (``loader.py``), the text data modules
(``text/``), optical flow's patch processor and the image preprocessing
(``vision/``) and the time-series CSV windows (``timeseries.py``). Batches are numpy dicts made on the host; the trainer moves them
to the card."""
