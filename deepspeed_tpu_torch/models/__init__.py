from deepspeed_tpu_torch.models.gpt import (
    GPTConfig,
    init_gpt_params,
    gpt_forward,
    make_gpt_model,
    make_gpt_decode_model,
    GPT2_CONFIGS,
)
from deepspeed_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    llama_config,
    make_llama_model,
    make_llama_decode_model,
)
from deepspeed_tpu_torch.models.bert import (
    BertConfig,
    BERT_CONFIGS,
    make_bert_model,
    bert_encode,
)
