"""Utilities of the port: label maps, the native boundary matcher's build
and loading, visualisation, the HDF5 feature cache (``utils.cache``) and
the NaN-checking mode behind ``eval.evaluate(debug_nans=True)``
(``utils.debug``) and the stages' profiler spans (``utils.trace``)."""

from gabor_color_image_segmentation_tpu_torch.utils.labels import agreement_rate, align_labels, relabel_contiguous

__all__ = ["relabel_contiguous", "align_labels", "agreement_rate"]
