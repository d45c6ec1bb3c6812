from early_exit_tpu_torch.serving.streaming import (StreamingRecognizer,  # noqa: F401
                                                    StreamPool)  # noqa: F401
