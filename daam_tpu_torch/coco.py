"""COCO label tables and ontology (standard public label sets).

The port's copy of ``daam_tpu/coco.py`` (framework-free; the port never
imports ``daam_tpu``).  ``tests/test_torch_shared.py`` holds it equal to
the original.
"""

from typing import Dict, List

__all__ = ['COCO80_LABELS', 'COCO80_INDICES', 'UNUSED_LABELS',
           'COCOSTUFF27_LABELS', 'COCO80_ONTOLOGY', 'COCO80_TO_27',
           'build_word_list_coco80']


# COCO label tables (standard public label sets; reference ``daam/experiment.py:18-79``).
COCO80_LABELS: List[str] = [
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train', 'truck', 'boat', 'traffic light',
    'fire hydrant', 'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee',
    'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon', 'bowl', 'banana', 'apple',
    'sandwich', 'orange', 'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch',
    'potted plant', 'bed', 'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote', 'keyboard', 'cell phone',
    'microwave', 'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush'
]

COCO80_INDICES: Dict[str, int] = {x: i for i, x in enumerate(COCO80_LABELS)}

UNUSED_LABELS: List[str] = [f'__unused_{i}__' for i in range(1, 200)]

COCOSTUFF27_LABELS: List[str] = [
    'electronic', 'appliance', 'food', 'furniture', 'indoor', 'kitchen', 'accessory', 'animal', 'outdoor', 'person',
    'sports', 'vehicle', 'ceiling', 'floor', 'food', 'furniture', 'rawmaterial', 'textile', 'wall', 'window',
    'building', 'ground', 'plant', 'sky', 'solid', 'structural', 'water'
]

COCO80_ONTOLOGY: Dict[str, List[str]] = {
    'two-wheeled vehicle': ['bicycle', 'motorcycle'],
    'vehicle': ['two-wheeled vehicle', 'four-wheeled vehicle'],
    'four-wheeled vehicle': ['bus', 'truck', 'car'],
    'four-legged animals': ['livestock', 'pets', 'wild animals'],
    'livestock': ['cow', 'horse', 'sheep'],
    'pets': ['cat', 'dog'],
    'wild animals': ['elephant', 'bear', 'zebra', 'giraffe'],
    'bags': ['backpack', 'handbag', 'suitcase'],
    'sports boards': ['snowboard', 'surfboard', 'skateboard'],
    'utensils': ['fork', 'knife', 'spoon'],
    'receptacles': ['bowl', 'cup'],
    'fruits': ['banana', 'apple', 'orange'],
    'foods': ['fruits', 'meals', 'desserts'],
    'meals': ['sandwich', 'hot dog', 'pizza'],
    'desserts': ['cake', 'donut'],
    'furniture': ['chair', 'couch', 'bench'],
    'electronics': ['monitors', 'appliances'],
    'monitors': ['tv', 'cell phone', 'laptop'],
    'appliances': ['oven', 'toaster', 'refrigerator'],
}

COCO80_TO_27: Dict[str, str] = {
    'bicycle': 'vehicle', 'car': 'vehicle', 'motorcycle': 'vehicle', 'airplane': 'vehicle', 'bus': 'vehicle',
    'train': 'vehicle', 'truck': 'vehicle', 'boat': 'vehicle', 'traffic light': 'accessory',
    'fire hydrant': 'accessory', 'stop sign': 'accessory', 'parking meter': 'accessory', 'bench': 'furniture',
    'bird': 'animal', 'cat': 'animal', 'dog': 'animal', 'horse': 'animal', 'sheep': 'animal', 'cow': 'animal',
    'elephant': 'animal', 'bear': 'animal', 'zebra': 'animal', 'giraffe': 'animal', 'backpack': 'accessory',
    'umbrella': 'accessory', 'handbag': 'accessory', 'tie': 'accessory', 'suitcase': 'accessory',
    'frisbee': 'sports', 'skis': 'sports', 'snowboard': 'sports', 'sports ball': 'sports', 'kite': 'sports',
    'baseball bat': 'sports', 'baseball glove': 'sports', 'skateboard': 'sports', 'surfboard': 'sports',
    'tennis racket': 'sports', 'bottle': 'food', 'wine glass': 'food', 'cup': 'food', 'fork': 'food',
    'knife': 'food', 'spoon': 'food', 'bowl': 'food', 'banana': 'food', 'apple': 'food', 'sandwich': 'food',
    'orange': 'food', 'broccoli': 'food', 'carrot': 'food', 'hot dog': 'food', 'pizza': 'food', 'donut': 'food',
    'cake': 'food', 'chair': 'furniture', 'couch': 'furniture', 'potted plant': 'plant', 'bed': 'furniture',
    'dining table': 'furniture', 'toilet': 'furniture', 'tv': 'electronic', 'laptop': 'electronic',
    'mouse': 'electronic', 'remote': 'electronic', 'keyboard': 'electronic', 'cell phone': 'electronic',
    'microwave': 'appliance', 'oven': 'appliance', 'toaster': 'appliance', 'sink': 'appliance',
    'refrigerator': 'appliance', 'book': 'indoor', 'clock': 'indoor', 'vase': 'indoor', 'scissors': 'indoor',
    'teddy bear': 'indoor', 'hair drier': 'indoor', 'toothbrush': 'indoor',
}


def build_word_list_coco80() -> Dict[str, List[str]]:
    """Leaf-only ontology categories (reference ``daam/experiment.py:82-86``)."""
    words_map = COCO80_ONTOLOGY.copy()
    return {k: v for k, v in words_map.items()
            if not any(item in COCO80_ONTOLOGY for item in v)}


