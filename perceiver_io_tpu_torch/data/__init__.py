"""The host data path for the port (counterpart of ``perceiver_io_tpu/data/``):
batch iteration and prefetch (``loader.py``), the text data modules
(``text/``), the MIDI codec and symbolic audio data modules (``audio/``),
optical flow's patch processor, the image preprocessing and MNIST
(``vision/``) and the time-series CSV windows (``timeseries.py``). Batches are numpy dicts made on the host; the trainer moves them
to the card."""
