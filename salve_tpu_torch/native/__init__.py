"""Image readers without imageio, PIL or cv2: JPEG through the system's
libjpeg (`jpeg.py`) and PNG on zlib and numpy (`png.py`), each with a small C
shim built at first use (`build.py`)."""
