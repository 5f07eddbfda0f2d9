// Native vectorized dm_control suite environments (EnvPool-equivalent, dmc
// track).
//
// The reference registers DMC tasks through the external C++ EnvPool
// (`rl_x/environments/envpool/dmc/humanoid_run_v1/create_env.py`); this file
// provides the same capability in-repo for the planar suite tasks
// (cheetah-run, walker-walk, walker-run): dm_control task semantics stepped
// in C++ against libmujoco with a persistent thread pool.  Exposed through a
// C ABI consumed via ctypes (rlx_tpu/environments/native/batcher.py,
// DMCNativeEnvBatch); the compiled .mjb model is prepared by the Python side
// from the dm_control package assets.
//
// Task semantics mirror dm_control exactly so the golden test can compare
// native vs dm_control trajectories from identical states
// (tests/test_native_dmc.py):
//  - control step = n_sub_steps x mj_step, then mj_step1 so position/
//    velocity-dependent fields (xmat, subtreelinvel sensor) match the
//    integrated state (dm_control "legacy_step" invariant,
//    dm_control/mujoco/engine.py:147-176);
//  - cheetah-run: obs [qpos[1:], qvel], reward = linear tolerance of the
//    torso subtree velocity (dm_control/suite/cheetah.py:61-66), init =
//    limited joints uniform in range + 200 stabilization steps;
//  - walker-walk/run: obs [body xmat (xx,xz) pairs, torso height, qvel],
//    reward = stand * (5*move+1)/6 with gaussian/linear tolerances
//    (dm_control/suite/walker.py:94-105), init = limited joints uniform +
//    unlimited hinges uniform(-pi, pi)
//    (dm_control/suite/utils/randomizers.py:35-70);
//  - no termination: episodes truncate at the suite step limit (1000).

#include <mujoco/mujoco.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ------------------------------------------------------------ thread pool
// (same design as envbatch.cpp's pool; kept local so each library is
// self-contained for the lazy g++ build)

class ThreadPool {
  public:
    explicit ThreadPool(int nr_threads) : stop_(false), pending_(0) {
        for (int i = 0; i < nr_threads; ++i) {
            workers_.emplace_back([this] {
                for (;;) {
                    std::function<void()> task;
                    {
                        std::unique_lock<std::mutex> lock(mu_);
                        cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
                        if (stop_ && tasks_.empty()) return;
                        task = std::move(tasks_.back());
                        tasks_.pop_back();
                    }
                    task();
                    if (--pending_ == 0) {
                        std::lock_guard<std::mutex> lock(done_mu_);
                        done_cv_.notify_all();
                    }
                }
            });
        }
    }

    ~ThreadPool() {
        {
            std::lock_guard<std::mutex> lock(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& w : workers_) w.join();
    }

    void run_chunks(int n, const std::function<void(int, int)>& fn) {
        int nr_workers = static_cast<int>(workers_.size());
        if (nr_workers <= 1 || n <= 1) {
            fn(0, n);
            return;
        }
        int chunk = (n + nr_workers - 1) / nr_workers;
        int nr_tasks = (n + chunk - 1) / chunk;
        pending_ = nr_tasks;
        {
            std::lock_guard<std::mutex> lock(mu_);
            for (int t = 0; t < nr_tasks; ++t) {
                int start = t * chunk;
                int end = std::min(n, start + chunk);
                tasks_.emplace_back([fn, start, end] { fn(start, end); });
            }
        }
        cv_.notify_all();
        std::unique_lock<std::mutex> lock(done_mu_);
        done_cv_.wait(lock, [this] { return pending_.load() == 0; });
    }

  private:
    std::vector<std::thread> workers_;
    std::vector<std::function<void()>> tasks_;
    std::mutex mu_, done_mu_;
    std::condition_variable cv_, done_cv_;
    std::atomic<bool> stop_;
    std::atomic<int> pending_;
};

// ------------------------------------------------------------ task specs

enum DmcTaskId { CHEETAH_RUN = 0, WALKER_WALK = 1, WALKER_RUN = 2 };

struct DmcSpec {
    int id;
    int n_sub_steps;     // cheetah 1 (dt 0.01), walker 10 (0.025 / 0.0025)
    int horizon;         // 1000 control steps for all three
    double move_speed;   // run-speed bound of the move tolerance
    bool stabilize_init; // cheetah: 200 free steps after joint randomization
};

DmcSpec make_spec(int id) {
    switch (id) {
        case CHEETAH_RUN:
            return {CHEETAH_RUN, 1, 1000, 10.0, true};
        case WALKER_WALK:
            return {WALKER_WALK, 10, 1000, 1.0, false};
        default:
            return {WALKER_RUN, 10, 1000, 8.0, false};
    }
}

// dm_control/utils/rewards.py tolerance() specializations
double linear_tolerance(double x, double lower, double margin, double value_at_margin) {
    if (x >= lower) return 1.0;
    double d = (lower - x) / margin;
    double scaled = d * (1.0 - value_at_margin);
    return std::abs(scaled) < 1.0 ? 1.0 - scaled : 0.0;
}

double gaussian_tolerance(double x, double lower, double margin, double value_at_margin) {
    if (x >= lower) return 1.0;
    double d = (lower - x) / margin;
    double scale = std::sqrt(-2.0 * std::log(value_at_margin));
    return std::exp(-0.5 * (d * scale) * (d * scale));
}

// ------------------------------------------------------------ batch

struct DmcBatch {
    mjModel* model = nullptr;
    DmcSpec spec;
    std::vector<mjData*> datas;
    std::vector<std::mt19937> rngs;
    std::vector<float> episode_return;
    std::vector<int> episode_length;
    std::vector<float> last_stats;  // [nr_envs, 2]
    ThreadPool pool;
    int nr_envs;
    int obs_dim;
    int vel_sensor_adr = -1;  // 'torso_subtreelinvel' x component
    int torso_body = -1;

    DmcBatch(mjModel* m, DmcSpec s, int n, uint64_t seed, int nr_threads)
        : model(m), spec(s), episode_return(n, 0.f), episode_length(n, 0),
          last_stats(2 * n, 0.f), pool(nr_threads), nr_envs(n) {
        int sensor = mj_name2id(model, mjOBJ_SENSOR, "torso_subtreelinvel");
        if (sensor >= 0) vel_sensor_adr = model->sensor_adr[sensor];
        torso_body = mj_name2id(model, mjOBJ_BODY, "torso");
        if (spec.id == CHEETAH_RUN) {
            obs_dim = (model->nq - 1) + model->nv;
        } else {
            obs_dim = 2 * (model->nbody - 1) + 1 + model->nv;
        }
        datas.reserve(n);
        rngs.reserve(n);
        for (int i = 0; i < n; ++i) {
            datas.push_back(mj_makeData(model));
            rngs.emplace_back(static_cast<uint32_t>(seed + i));
        }
    }

    ~DmcBatch() {
        for (auto* d : datas) mj_deleteData(d);
        mj_deleteModel(model);
    }

    void reset_env(int i) {
        mjData* d = datas[i];
        mj_resetData(model, d);
        auto& rng = rngs[i];
        for (int j = 0; j < model->njnt; ++j) {
            int adr = model->jnt_qposadr[j];
            if (model->jnt_limited[j]) {
                std::uniform_real_distribution<double> u(model->jnt_range[2 * j],
                                                         model->jnt_range[2 * j + 1]);
                d->qpos[adr] = u(rng);
            } else if (spec.id != CHEETAH_RUN && model->jnt_type[j] == mjJNT_HINGE) {
                // walker: unlimited hinges uniform in [-pi, pi]
                // (cheetah's init only touches LIMITED joints, cheetah.py:49-52)
                std::uniform_real_distribution<double> u(-M_PI, M_PI);
                d->qpos[adr] = u(rng);
            }
        }
        if (spec.stabilize_init) {
            for (int k = 0; k < 200; ++k) mj_step(model, d);
            d->time = 0;
        }
        mj_step1(model, d);  // derived fields in sync for obs
        episode_return[i] = 0.f;
        episode_length[i] = 0;
    }

    void observe(const mjData* d, float* obs) const {
        int k = 0;
        if (spec.id == CHEETAH_RUN) {
            for (int j = 1; j < model->nq; ++j) obs[k++] = static_cast<float>(d->qpos[j]);
        } else {
            // orientations: xmat (xx, xz) of every non-world body
            for (int b = 1; b < model->nbody; ++b) {
                obs[k++] = static_cast<float>(d->xmat[9 * b + 0]);
                obs[k++] = static_cast<float>(d->xmat[9 * b + 2]);
            }
            obs[k++] = static_cast<float>(d->xpos[3 * torso_body + 2]);  // height
        }
        for (int j = 0; j < model->nv; ++j) obs[k++] = static_cast<float>(d->qvel[j]);
    }

    double reward(const mjData* d) const {
        double speed = vel_sensor_adr >= 0 ? d->sensordata[vel_sensor_adr] : 0.0;
        if (spec.id == CHEETAH_RUN) {
            // tolerance(speed, (10, inf), margin=10, value_at_margin=0, linear)
            return linear_tolerance(speed, spec.move_speed, spec.move_speed, 0.0);
        }
        double height = d->xpos[3 * torso_body + 2];
        double upright = (1.0 + d->xmat[9 * torso_body + 8]) / 2.0;
        double standing = gaussian_tolerance(height, 1.2, 0.6, 0.1);
        double stand_reward = (3.0 * standing + upright) / 4.0;
        double move = linear_tolerance(speed, spec.move_speed, spec.move_speed / 2.0, 0.5);
        return stand_reward * (5.0 * move + 1.0) / 6.0;
    }

    void reset(float* obs_out) {
        pool.run_chunks(nr_envs, [&](int start, int end) {
            for (int i = start; i < end; ++i) {
                reset_env(i);
                observe(datas[i], obs_out + i * obs_dim);
                last_stats[2 * i] = last_stats[2 * i + 1] = 0.f;
            }
        });
    }

    void step(const float* actions, float* obs_out, float* final_obs_out,
              float* reward_out, uint8_t* term_out, uint8_t* trunc_out,
              float* stats_out) {
        int nu = model->nu;
        pool.run_chunks(nr_envs, [&](int start, int end) {
            for (int i = start; i < end; ++i) {
                mjData* d = datas[i];
                for (int a = 0; a < nu; ++a)
                    d->ctrl[a] = static_cast<double>(actions[i * nu + a]);
                for (int f = 0; f < spec.n_sub_steps; ++f) mj_step(model, d);
                mj_step1(model, d);  // sync xmat/sensors with integrated state

                double r = reward(d);
                observe(d, final_obs_out + i * obs_dim);
                episode_return[i] += static_cast<float>(r);
                episode_length[i] += 1;
                // dm_control suite tasks end only via the time limit (LAST
                // with discount 1.0) -> truncation, never termination
                bool truncated = episode_length[i] >= spec.horizon;
                reward_out[i] = static_cast<float>(r);
                term_out[i] = 0;
                trunc_out[i] = truncated ? 1 : 0;
                if (truncated) {
                    last_stats[2 * i] = episode_return[i];
                    last_stats[2 * i + 1] = static_cast<float>(episode_length[i]);
                    reset_env(i);
                }
                observe(d, obs_out + i * obs_dim);
                stats_out[2 * i] = last_stats[2 * i];
                stats_out[2 * i + 1] = last_stats[2 * i + 1];
            }
        });
    }
};

}  // namespace

extern "C" {

void* dmcbatch_create(const char* mjb_path, const char* task, int nr_envs,
                      uint64_t seed, int nr_threads) {
    int id;
    if (std::string(task) == "cheetah_run") id = CHEETAH_RUN;
    else if (std::string(task) == "walker_walk") id = WALKER_WALK;
    else if (std::string(task) == "walker_run") id = WALKER_RUN;
    else return nullptr;
    mjModel* m = mj_loadModel(mjb_path, nullptr);
    if (!m) return nullptr;
    if (nr_threads <= 0)
        nr_threads = std::max(1u, std::thread::hardware_concurrency());
    return new DmcBatch(m, make_spec(id), nr_envs, seed, nr_threads);
}

int dmcbatch_obs_dim(void* handle) { return static_cast<DmcBatch*>(handle)->obs_dim; }

int dmcbatch_act_dim(void* handle) {
    return static_cast<DmcBatch*>(handle)->model->nu;
}

int dmcbatch_horizon(void* handle) {
    return static_cast<DmcBatch*>(handle)->spec.horizon;
}

void dmcbatch_ctrl_range(void* handle, float* lo, float* hi) {
    auto* b = static_cast<DmcBatch*>(handle);
    for (int a = 0; a < b->model->nu; ++a) {
        lo[a] = static_cast<float>(b->model->actuator_ctrlrange[2 * a]);
        hi[a] = static_cast<float>(b->model->actuator_ctrlrange[2 * a + 1]);
    }
}

void dmcbatch_reset(void* handle, float* obs_out) {
    static_cast<DmcBatch*>(handle)->reset(obs_out);
}

void dmcbatch_step(void* handle, const float* actions, float* obs_out,
                   float* final_obs_out, float* reward_out, uint8_t* term_out,
                   uint8_t* trunc_out, float* stats_out) {
    static_cast<DmcBatch*>(handle)->step(actions, obs_out, final_obs_out,
                                         reward_out, term_out, trunc_out, stats_out);
}

void dmcbatch_set_state(void* handle, int env, const double* qpos, const double* qvel) {
    auto* b = static_cast<DmcBatch*>(handle);
    mjData* d = b->datas[env];
    std::memcpy(d->qpos, qpos, sizeof(double) * b->model->nq);
    std::memcpy(d->qvel, qvel, sizeof(double) * b->model->nv);
    mj_step1(b->model, d);
}

void dmcbatch_get_state(void* handle, int env, double* qpos, double* qvel) {
    auto* b = static_cast<DmcBatch*>(handle);
    const mjData* d = b->datas[env];
    std::memcpy(qpos, d->qpos, sizeof(double) * b->model->nq);
    std::memcpy(qvel, d->qvel, sizeof(double) * b->model->nv);
}

void dmcbatch_destroy(void* handle) { delete static_cast<DmcBatch*>(handle); }

}  // extern "C"
