"""Frontend: u2net matting and the crop/pad/resize preprocessing."""

from sculptmate_tpu_torch.frontend.matting import U2NetMatting, remove  # noqa: F401
from sculptmate_tpu_torch.frontend.preprocess import (  # noqa: F401
    preprocess_batch_device,
    preprocess_device_one,
    preprocess_image,
)
