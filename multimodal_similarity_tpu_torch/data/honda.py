"""Honda HDD label maps and event-slicing constants.

Reference: preprocess/label_transfer.py:1-40 ("label version for NIPS
experiments") and preprocess/honda_labels.py.
"""

MIN_LENGTH = 5              # drop events shorter than this
MIN_LENGTH_BACKGROUND = 15  # drop background events shorter than this
MAX_LENGTH = 45             # cap event length (frames)

# raw 11-class annotation -> 7-class goal label set
LABEL_TRANSFER = {
    0: 0,   # background
    1: 1,   # intersection passing
    2: 2,   # left turn
    3: 3,   # right turn
    4: 4,   # left lane change
    5: 5,   # right lane change
    6: 1,   # crosswalk passing -> intersection passing
    7: 6,   # U-turn
    8: 4,   # left lane branch -> left lane change
    9: 5,   # right lane branch -> right lane change
    10: 0,  # merge -> background
}

HONDA_NUM2LABELS = {
    0: "Background",
    1: "Intersection passing",
    2: "Left turn",
    3: "Right turn",
    4: "Left lane change",
    5: "Right lane change",
    6: "U-turn",
}

STIMULI_NUM2LABELS = {
    0: "Background",
    1: "Stop 4 sign",
    2: "Stop 4 light",
    3: "Stop 4 congestion",
    4: "Stop 4 others",
    5: "Stop 4 pedestrian",
    6: "Avoid TP",
    7: "Avoid parked car",
    8: "Avoid pedesrian near ego lane",
    9: "Avoid on-road bicyclist",
}

# per-modality feature-file suffixes (data_io.py:14-25)
MODALITY_SUFFIX = {
    "resnet": ".npy",
    "sensors": "_sensors_normalized.npy",
    "sensors_sae": "_sensors_normalized_sae.npy",
    "segment": "_seg_sp.npy",
    "segment_down": "_seg_down.npy",
}
