"""Kinematic chains and raw bone-direction tables (static metadata).

Copy of gesturediffusion_tpu/utils/paramutil.py for the port: the kit
(21 joints) and t2m (22 joints, HumanML3D) chains and raw offsets, the
t2m hand chains and the 83-joint GENEA skeleton's five chains that the
stick-figure videos draw.  Facts about the datasets' skeletons, not code.
"""

import numpy as np

kit_kinematic_chain = [
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
]

kit_raw_offsets = np.array(
    [
        [0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0],
        [1, 0, 0], [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0],
        [0, -1, 0], [1, 0, 0], [0, -1, 0], [0, -1, 0], [0, 0, 1],
        [0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [0, 0, 1],
        [0, 0, 1],
    ]
)

t2m_raw_offsets = np.array(
    [
        [0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
        [0, -1, 0], [0, 1, 0], [0, -1, 0], [0, -1, 0], [0, 1, 0],
        [0, 0, 1], [0, 0, 1], [0, 1, 0], [1, 0, 0], [-1, 0, 0],
        [0, 0, 1], [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0],
        [0, -1, 0], [0, -1, 0],
    ]
)

t2m_kinematic_chain = [
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
]
t2m_left_hand_chain = [
    [20, 22, 23, 24], [20, 34, 35, 36], [20, 25, 26, 27],
    [20, 31, 32, 33], [20, 28, 29, 30],
]
t2m_right_hand_chain = [
    [21, 43, 44, 45], [21, 46, 47, 48], [21, 40, 41, 42],
    [21, 37, 38, 39], [21, 49, 50, 51],
]

# 83-joint GENEA BVH skeleton, 5 chains used for stick-figure viz:
# legs, spine/head, right arm, left arm
genea2022_kinematic_chain = [
    [1, 75, 76, 77, 78],
    [1, 79, 80, 81, 82],
    [1, 3, 4, 5, 6, 7],
    [6, 27, 29, 31, 33],
    [6, 50, 53, 55, 57],
]

kit_tgt_skel_id = "03950"
t2m_tgt_skel_id = "000021"
