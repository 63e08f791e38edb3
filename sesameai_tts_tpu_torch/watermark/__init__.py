from sesameai_tts_tpu_torch.watermark.api import (  # noqa: F401
    CSM_1B_GH_WATERMARK,
    CSM_1B_WATERMARK,
    check_audio_from_file,
    load_watermarker,
    verify,
    watermark,
)
