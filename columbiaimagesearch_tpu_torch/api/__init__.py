from columbiaimagesearch_tpu_torch.api.app import SearchAPI, make_server
