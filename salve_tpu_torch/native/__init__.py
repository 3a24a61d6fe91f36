"""Image IO without imageio, PIL or cv2: a JPEG codec written by hand
(`jpeg.py`, `jpeg_codec.c`) and PNG on zlib and numpy (`png.py`), each with
a small C file built at first use (`build.py`)."""
