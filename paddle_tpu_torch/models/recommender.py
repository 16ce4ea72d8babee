"""Recommender on MovieLens — book chapter 05 (counterpart of
paddle_tpu/models/recommender.py; reference:
python/paddle/fluid/tests/book/test_recommender_system.py): user and
movie towers, the movie's category and title as sequences, a cosine
similarity regressed onto the rating."""

from __future__ import annotations

from .. import layers, nets

IS_SPARSE = True


def get_usr_combined_features(user_id_max, job_max=21, age_max=7):
    usr = layers.data(name="user_id", shape=[1], dtype="int64")
    emb = layers.embedding(input=usr, size=[user_id_max, 32],
                           is_sparse=IS_SPARSE)
    usr_fc = layers.fc(input=emb, size=32)
    gender = layers.data(name="gender_id", shape=[1], dtype="int64")
    g_emb = layers.embedding(input=gender, size=[2, 16], is_sparse=IS_SPARSE)
    g_fc = layers.fc(input=g_emb, size=16)
    age = layers.data(name="age_id", shape=[1], dtype="int64")
    a_emb = layers.embedding(input=age, size=[age_max, 16],
                             is_sparse=IS_SPARSE)
    a_fc = layers.fc(input=a_emb, size=16)
    job = layers.data(name="job_id", shape=[1], dtype="int64")
    j_emb = layers.embedding(input=job, size=[job_max, 16],
                             is_sparse=IS_SPARSE)
    j_fc = layers.fc(input=j_emb, size=16)
    concat = layers.concat(input=[usr_fc, g_fc, a_fc, j_fc], axis=1)
    return layers.fc(input=concat, size=200, act="tanh")


def get_mov_combined_features(movie_id_max, category_size=19,
                              title_dict_size=5175):
    mov = layers.data(name="movie_id", shape=[1], dtype="int64")
    emb = layers.embedding(input=mov, size=[movie_id_max, 32],
                           is_sparse=IS_SPARSE)
    mov_fc = layers.fc(input=emb, size=32)
    category = layers.data(name="category_id", shape=[-1, -1, 1],
                           dtype="int64", lod_level=1,
                           append_batch_size=False)
    cat_emb = layers.embedding(input=category, size=[category_size, 32],
                               is_sparse=IS_SPARSE)
    cat_pool = layers.sequence_pool(input=cat_emb, pool_type="sum")
    title = layers.data(name="movie_title", shape=[-1, -1, 1], dtype="int64",
                        lod_level=1, append_batch_size=False)
    title_emb = layers.embedding(input=title, size=[title_dict_size, 32],
                                 is_sparse=IS_SPARSE)
    title_conv = nets.sequence_conv_pool(input=title_emb, num_filters=32,
                                         filter_size=3, act="tanh",
                                         pool_type="sum")
    concat = layers.concat(input=[mov_fc, cat_pool, title_conv], axis=1)
    return layers.fc(input=concat, size=200, act="tanh")


def build_train(user_id_max=6040 + 1, movie_id_max=3952 + 1):
    """(avg_cost, scale_infer) of the rating regression."""
    usr = get_usr_combined_features(user_id_max)
    mov = get_mov_combined_features(movie_id_max)
    inference = layers.cos_sim(X=usr, Y=mov)
    scale_infer = layers.scale(x=inference, scale=5.0)
    label = layers.data(name="score", shape=[1], dtype="float32")
    cost = layers.square_error_cost(input=scale_infer, label=label)
    avg_cost = layers.mean(cost)
    return avg_cost, scale_infer
