"""Weight conversion. Counterpart of ``perceiver_io_tpu/convert``: the
reference's PyTorch state_dicts into the port (:mod:`.torch_import`), the
Hugging Face Perceiver models into the port (:mod:`.hf_import`), the port's
weights out to the reference's formats (:mod:`.export`), and JAX param
trees into the port (:mod:`.from_jax`)."""
from perceiver_io_tpu_torch.convert.export import (
    export_causal_language_model,
    export_image_classifier,
    export_masked_language_model,
    export_optical_flow,
    export_symbolic_audio_model,
    export_text_classifier,
    infer_task,
    save_reference_checkpoint,
)
from perceiver_io_tpu_torch.convert.torch_import import (
    import_causal_language_model,
    import_image_classifier,
    import_masked_language_model,
    import_optical_flow,
    import_symbolic_audio_model,
    import_text_classifier,
)
