from columbiaimagesearch_tpu_torch.imgio.imgio import (
    buffer_to_B64,
    get_buffer_from_B64,
    get_buffer_from_URL,
    get_buffer_from_filepath,
    get_SHA1_from_buffer,
    get_SHA1_from_data,
    get_SHA1_img_info_from_buffer,
    get_image_size_and_format,
    load_image_from_buffer,
)
