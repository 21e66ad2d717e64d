"""Port parity of stage 4's neural-LM paths for RNN-T: `RNNTBeamDecoder`
fused with the neural LM of a JAX LM experiment (decode.lm "nn", with a
neural decode.rescore) and with LODR (that LM and a token 2-gram of
negative weight), against `cat_tpu.pipeline.asr` on one JAX checkpoint
of the asr-rnnt template (the fixtures of
`tests/test_torch_lm_decode.py`): texts equal, scores within 1e-4."""
import pytest

from tests.test_torch_lm_decode import NEURAL_RNNT, neural_stage_4
from tests.test_torch_pipeline import staged, yesno

assert staged and yesno  # module fixtures, shared with the pipeline tests


@pytest.mark.parametrize("family,lm_config,decode", NEURAL_RNNT)
def test_neural_lm_rnnt_stage_4_matches_jax(staged, tmp_path, family,
                                            lm_config, decode):
    neural_stage_4(staged, tmp_path, family, lm_config, decode)
