"""ShapeNet category maps (copy of ``octfusion_tpu/data/shapenet.py``;
the reference's ``utils/util.py:12-30`` and ``datasets/shapenet_utils.py``)."""

category_5_to_label = {
    "airplane": 0,
    "car": 1,
    "chair": 2,
    "table": 3,
    "rifle": 4,
}

# per-category eval-set sizes (the reference's ``utils/util.py:19``)
category_5_to_num = {
    "airplane": 2831,
    "car": 5247,
    "chair": 4744,
    "table": 5956,
    "rifle": 1660,
    "im_5": 10000,
}

synset_to_category = {
    "02691156": "airplane",
    "02958343": "car",
    "03001627": "chair",
    "04379243": "table",
    "04090263": "rifle",
}


def synset_to_label(synset: str) -> int:
    cat = synset_to_category.get(synset)
    return category_5_to_label.get(cat, 0) if cat else 0
