from perceiver_io_tpu_torch.data.vision.mnist import MNISTDataModule
from perceiver_io_tpu_torch.data.vision.optical_flow import OpticalFlowProcessor, render_optical_flow
from perceiver_io_tpu_torch.data.vision.preprocessor import ImageNetPreprocessor, ImagePreprocessor

__all__ = ["ImageNetPreprocessor", "ImagePreprocessor", "MNISTDataModule", "OpticalFlowProcessor",
           "render_optical_flow"]
