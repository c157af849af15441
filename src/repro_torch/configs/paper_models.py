"""The paper's own evaluation models (§4.1), port of
``repro.configs.paper_models``: VGG-8 and ResNet-18 on CIFAR-scale
inputs; YOLO (DarkNet-19) and Tiny-YOLO on 416x416 VOC."""

from repro_torch.models.cnn import CNNConfig

VGG8 = CNNConfig(name="vgg8", num_classes=100, input_size=32)
RESNET18 = CNNConfig(name="resnet18", num_classes=100, input_size=32)
DARKNET19_YOLO = CNNConfig(name="darknet19", input_size=416,
                           head_anchors=5, head_classes=20)
TINY_YOLO = CNNConfig(name="tiny_yolo", input_size=416,
                      head_anchors=5, head_classes=20)

PAPER_MODELS = {
    "vgg8": VGG8,
    "resnet18": RESNET18,
    "darknet19": DARKNET19_YOLO,
    "tiny_yolo": TINY_YOLO,
}
