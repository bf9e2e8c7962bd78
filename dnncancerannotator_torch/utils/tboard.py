'''PNG encoding for prediction maps (counterpart of
dnncancerannotator_tpu.utils.tboard.encode_png; the event writer is not
ported yet). Pillow is imported only when a PNG is encoded.'''

import io

import numpy as np


def encode_png(array, bitdepth=8):
    '''Encode [H, W] or [H, W, C] uint8/float array to PNG bytes.

    ``bitdepth=16`` writes a 16-bit grayscale PNG; the input is then taken
    as values in [0, 65535] (floats are clipped and rounded).
    '''
    from PIL import Image
    array = np.asarray(array)
    if bitdepth == 16:
        if array.ndim == 3 and array.shape[-1] == 1:
            array = array[..., 0]
        if array.ndim != 2:
            raise ValueError(f'16-bit PNG needs a 2-D array, got {array.shape}')
        array = np.clip(array, 0, 65535).astype(np.uint16)
        img = Image.fromarray(array)   # uint16 [H, W] is mode I;16
    else:
        if array.dtype != np.uint8:
            array = np.clip(array * 255.0, 0, 255).astype(np.uint8)
        if array.ndim == 3 and array.shape[-1] == 1:
            array = array[..., 0]
        img = Image.fromarray(array, mode='L' if array.ndim == 2 else 'RGB')
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return buf.getvalue()
