// Native vectorized MuJoCo environments (EnvPool-equivalent, mujoco track).
//
// The reference registers Gym MuJoCo tasks through the external C++ EnvPool
// (`rl_x/environments/envpool/mujoco/*/create_env.py`); this file provides
// the same capability in-repo: Gymnasium MuJoCo v5 task semantics (hopper,
// half_cheetah, walker2d) stepped in C++ against libmujoco with a
// persistent thread pool, same-step auto-reset and episode statistics.
// Exposed through a C ABI consumed via ctypes
// (rlx_tpu/environments/native/batcher.py, MujocoNativeEnvBatch).
//
// Build (driven by batcher.py; include/lib paths come from the installed
// mujoco wheel):
//   g++ -O3 -std=c++17 -shared -fPIC -I<mujoco>/include \
//       -o libenvbatch_mujoco.so envbatch_mujoco.cpp \
//       -L<mujoco> -l:libmujoco.so.<ver> -Wl,-rpath,<mujoco> -lpthread
//
// Task semantics mirror Gymnasium v5 defaults exactly (reward weights,
// healthy ranges, reset noise, frame skips, observation layouts) so the
// golden test can compare native vs gymnasium transitions from identical
// states (tests/test_native_mujoco.py).

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

    void run_chunks(int total, const std::function<void(int, int)>& fn) {
        int nr = static_cast<int>(workers_.size());
        int chunk = (total + nr - 1) / nr;
        int launched = 0;
        {
            std::lock_guard<std::mutex> lock(mu_);
            for (int start = 0; start < total; start += chunk) {
                int end = std::min(start + chunk, total);
                tasks_.emplace_back([fn, start, end] { fn(start, end); });
                ++launched;
            }
            pending_ += launched;
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

enum TaskId { HOPPER = 0, HALF_CHEETAH = 1, WALKER2D = 2 };

struct TaskSpec {
    int id;
    int frame_skip;
    int horizon;
    double forward_reward_weight;
    double ctrl_cost_weight;
    double healthy_reward;     // 0 when the task never terminates
    bool terminates;
    // reset noise
    bool uniform_reset;        // uniform(+-scale) on qpos AND qvel
    double reset_noise_scale;  // hopper/walker2d 5e-3; half_cheetah 0.1 (qpos)
    // observation
    bool clip_qvel;            // clip(qvel, +-10) in obs (hopper/walker2d)
};

TaskSpec make_spec(int id) {
    switch (id) {
        case HOPPER:
            return {HOPPER, 4, 1000, 1.0, 1e-3, 1.0, true, true, 5e-3, true};
        case WALKER2D:
            return {WALKER2D, 4, 1000, 1.0, 1e-3, 1.0, true, true, 5e-3, true};
        default:
            return {HALF_CHEETAH, 5, 1000, 1.0, 0.1, 0.0, false, false, 0.1, false};
    }
}

// ------------------------------------------------------------ batch

struct MujocoBatch {
    mjModel* model = nullptr;
    TaskSpec spec;
    std::vector<mjData*> datas;
    std::vector<std::mt19937> rngs;
    std::vector<float> episode_return;
    std::vector<int> episode_length;
    std::vector<float> last_stats;  // [nr_envs, 2]
    ThreadPool pool;
    int nr_envs;
    int obs_dim;

    MujocoBatch(mjModel* m, TaskSpec s, int n, uint64_t seed, int nr_threads)
        : model(m), spec(s), episode_return(n, 0.f), episode_length(n, 0),
          last_stats(2 * n, 0.f), pool(nr_threads), nr_envs(n) {
        obs_dim = (model->nq - 1) + model->nv;
        datas.reserve(n);
        rngs.reserve(n);
        for (int i = 0; i < n; ++i) {
            datas.push_back(mj_makeData(model));
            rngs.emplace_back(static_cast<uint32_t>(seed + i));
        }
    }

    ~MujocoBatch() {
        for (auto* d : datas) mj_deleteData(d);
        mj_deleteModel(model);
    }

    bool is_healthy(const mjData* d) const {
        if (!spec.terminates) return true;
        double z = d->qpos[1];
        double angle = d->qpos[2];
        if (spec.id == HOPPER) {
            // healthy_z (0.7, inf), healthy_angle (-0.2, 0.2),
            // healthy_state (-100, 100) over qpos[2:] + qvel
            for (int i = 2; i < model->nq; ++i)
                if (std::abs(d->qpos[i]) >= 100.0) return false;
            for (int i = 0; i < model->nv; ++i)
                if (std::abs(d->qvel[i]) >= 100.0) return false;
            return z > 0.7 && angle > -0.2 && angle < 0.2;
        }
        // walker2d: healthy_z (0.8, 2.0), healthy_angle (-1.0, 1.0)
        return z > 0.8 && z < 2.0 && angle > -1.0 && angle < 1.0;
    }

    void reset_env(int i) {
        mjData* d = datas[i];
        mj_resetData(model, d);
        auto& rng = rngs[i];
        if (spec.uniform_reset) {
            std::uniform_real_distribution<double> u(-spec.reset_noise_scale,
                                                     spec.reset_noise_scale);
            for (int j = 0; j < model->nq; ++j) d->qpos[j] = model->qpos0[j] + u(rng);
            for (int j = 0; j < model->nv; ++j) d->qvel[j] = u(rng);
        } else {
            // half_cheetah: qpos uniform(+-0.1), qvel standard-normal * 0.1
            std::uniform_real_distribution<double> u(-spec.reset_noise_scale,
                                                     spec.reset_noise_scale);
            std::normal_distribution<double> nrm(0.0, 1.0);
            for (int j = 0; j < model->nq; ++j) d->qpos[j] = model->qpos0[j] + u(rng);
            for (int j = 0; j < model->nv; ++j) d->qvel[j] = nrm(rng) * spec.reset_noise_scale;
        }
        mj_forward(model, d);
        episode_return[i] = 0.f;
        episode_length[i] = 0;
    }

    void observe(const mjData* d, float* obs) const {
        int k = 0;
        for (int j = 1; j < model->nq; ++j) obs[k++] = static_cast<float>(d->qpos[j]);
        for (int j = 0; j < model->nv; ++j) {
            double v = d->qvel[j];
            if (spec.clip_qvel) v = std::max(-10.0, std::min(10.0, v));
            obs[k++] = static_cast<float>(v);
        }
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
                double x_before = d->qpos[0];
                double ctrl_cost = 0.0;
                for (int a = 0; a < nu; ++a) {
                    double c = static_cast<double>(actions[i * nu + a]);
                    d->ctrl[a] = c;
                    ctrl_cost += c * c;
                }
                for (int f = 0; f < spec.frame_skip; ++f) mj_step(model, d);
                // gym reads velocities etc. via mj_rnePostConstraint-complete
                // forward data; qpos/qvel are already integrated
                double dt = model->opt.timestep * spec.frame_skip;
                double x_velocity = (d->qpos[0] - x_before) / dt;
                bool healthy = is_healthy(d);
                double reward = spec.forward_reward_weight * x_velocity
                              - spec.ctrl_cost_weight * ctrl_cost
                              + (healthy ? spec.healthy_reward : 0.0);
                bool terminated = spec.terminates && !healthy;

                observe(d, final_obs_out + i * obs_dim);
                episode_return[i] += static_cast<float>(reward);
                episode_length[i] += 1;
                bool truncated = !terminated && episode_length[i] >= spec.horizon;
                reward_out[i] = static_cast<float>(reward);
                term_out[i] = terminated ? 1 : 0;
                trunc_out[i] = truncated ? 1 : 0;
                if (terminated || truncated) {
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

void* mjbatch_create(const char* xml_path, const char* task, int nr_envs,
                     uint64_t seed, int nr_threads) {
    int task_id;
    if (std::strcmp(task, "hopper") == 0) task_id = HOPPER;
    else if (std::strcmp(task, "half_cheetah") == 0) task_id = HALF_CHEETAH;
    else if (std::strcmp(task, "walker2d") == 0) task_id = WALKER2D;
    else return nullptr;

    char error[512];
    mjModel* m = mj_loadXML(xml_path, nullptr, error, sizeof(error));
    if (!m) return nullptr;
    if (nr_threads <= 0) {
        nr_threads = std::max(1u, std::thread::hardware_concurrency() / 2);
    }
    return new MujocoBatch(m, make_spec(task_id), nr_envs, seed, nr_threads);
}

int mjbatch_obs_dim(void* handle) { return static_cast<MujocoBatch*>(handle)->obs_dim; }

int mjbatch_act_dim(void* handle) {
    return static_cast<MujocoBatch*>(handle)->model->nu;
}

int mjbatch_horizon(void* handle) {
    return static_cast<MujocoBatch*>(handle)->spec.horizon;
}

void mjbatch_ctrl_range(void* handle, float* lo, float* hi) {
    auto* b = static_cast<MujocoBatch*>(handle);
    for (int a = 0; a < b->model->nu; ++a) {
        lo[a] = static_cast<float>(b->model->actuator_ctrlrange[2 * a]);
        hi[a] = static_cast<float>(b->model->actuator_ctrlrange[2 * a + 1]);
    }
}

void mjbatch_reset(void* handle, float* obs_out) {
    static_cast<MujocoBatch*>(handle)->reset(obs_out);
}

void mjbatch_step(void* handle, const float* actions, float* obs_out,
                  float* final_obs_out, float* reward_out, uint8_t* term_out,
                  uint8_t* trunc_out, float* stats_out) {
    static_cast<MujocoBatch*>(handle)->step(actions, obs_out, final_obs_out,
                                            reward_out, term_out, trunc_out,
                                            stats_out);
}

// test hooks: exact-state golden comparison against gymnasium
void mjbatch_set_state(void* handle, int env, const double* qpos, const double* qvel) {
    auto* b = static_cast<MujocoBatch*>(handle);
    mjData* d = b->datas[env];
    std::memcpy(d->qpos, qpos, sizeof(double) * b->model->nq);
    std::memcpy(d->qvel, qvel, sizeof(double) * b->model->nv);
    mj_forward(b->model, d);
}

void mjbatch_get_state(void* handle, int env, double* qpos, double* qvel) {
    auto* b = static_cast<MujocoBatch*>(handle);
    mjData* d = b->datas[env];
    std::memcpy(qpos, d->qpos, sizeof(double) * b->model->nq);
    std::memcpy(qvel, d->qvel, sizeof(double) * b->model->nv);
}

void mjbatch_destroy(void* handle) { delete static_cast<MujocoBatch*>(handle); }

}  // extern "C"
