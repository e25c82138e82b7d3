"""Data path of the port: the record cache (``cache``), the host dataset of
gray canvases (``dataset``), the threaded loader with overlapped device
copies (``loader``), the train augmentation and the eval/detect resize
(``transform``), and the device-resident dataset (``device_cache``)."""
