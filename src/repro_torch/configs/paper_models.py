"""Layer-shape tables of the paper's five evaluation DNNs (Fig. 22): the
JAX package's ``configs/paper_models.py``, shape for shape.

Shapes from the published architectures; (weight, activation) sparsities
follow the per-layer ranges the paper reports for AGP-pruned CNNs,
movement-pruned BERT, and AGP RNNs (paper §VI-A, Fig. 22).  GEMM layers
are (M=tokens, K, N); CONV layers are (H, W, Cin, Cout, KH, KW, stride).
"""
from typing import List, NamedTuple


class ConvLayer(NamedTuple):
    name: str
    h: int
    w: int
    cin: int
    cout: int
    k: int
    stride: int
    w_sparsity: float
    a_sparsity: float


class GemmLayer(NamedTuple):
    name: str
    m: int
    k: int
    n: int
    w_sparsity: float
    a_sparsity: float


VGG16: List[ConvLayer] = [
    ConvLayer("conv1_2", 224, 224, 64, 64, 3, 1, 0.42, 0.50),
    ConvLayer("conv2_2", 112, 112, 128, 128, 3, 1, 0.60, 0.55),
    ConvLayer("conv3_3", 56, 56, 256, 256, 3, 1, 0.65, 0.62),
    ConvLayer("conv4_3", 28, 28, 512, 512, 3, 1, 0.70, 0.70),
    ConvLayer("conv5_3", 14, 14, 512, 512, 3, 1, 0.75, 0.78),
]

RESNET18: List[ConvLayer] = [
    ConvLayer("layer1-1", 56, 56, 64, 64, 3, 1, 0.50, 0.45),
    ConvLayer("layer2-1", 28, 28, 128, 128, 3, 1, 0.60, 0.55),
    ConvLayer("layer3-1", 14, 14, 256, 256, 3, 1, 0.65, 0.65),
    ConvLayer("layer4-1", 7, 7, 512, 512, 3, 1, 0.70, 0.72),
    ConvLayer("layer5-4", 7, 7, 512, 512, 3, 1, 0.72, 0.60),
]

MASK_RCNN: List[ConvLayer] = [
    ConvLayer("res2", 256, 256, 64, 64, 3, 1, 0.50, 0.48),
    ConvLayer("res3", 128, 128, 128, 128, 3, 1, 0.60, 0.55),
    ConvLayer("res4", 64, 64, 256, 256, 3, 1, 0.65, 0.66),
    ConvLayer("fpn", 64, 64, 256, 256, 3, 1, 0.55, 0.60),
]

# BERT-base encoder (movement pruning [54]: ~90%+ weight sparsity, dense
# activations — weight-side-dominant dual sparsity)
BERT_BASE: List[GemmLayer] = [
    GemmLayer("attn.qkv", 384, 768, 2304, 0.90, 0.0),
    GemmLayer("attn.out", 384, 768, 768, 0.92, 0.0),
    GemmLayer("ffn.in", 384, 768, 3072, 0.94, 0.0),
    GemmLayer("ffn.out", 384, 3072, 768, 0.94, 0.12),  # post-GeLU zeros
]

# 2-layer LSTM encoder + 4-layer decoder (AGP ≥90% weight sparsity)
RNN: List[GemmLayer] = [
    GemmLayer("enc.l0", 64, 1500, 6000, 0.90, 0.0),
    GemmLayer("enc.l1", 64, 1500, 6000, 0.92, 0.35),
    GemmLayer("dec.l0", 64, 1500, 6000, 0.93, 0.35),
    GemmLayer("dec.l3", 64, 1500, 6000, 0.95, 0.35),
]

MODELS = {
    "vgg16": VGG16,
    "resnet18": RESNET18,
    "mask_rcnn": MASK_RCNN,
    "bert_base": BERT_BASE,
    "rnn": RNN,
}
